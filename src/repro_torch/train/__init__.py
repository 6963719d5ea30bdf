"""The LM's training half: AdamW on parameter trees (``optimizer``), int8
gradient compression with error feedback (``compression``), the paper's
fixed-point integer all-reduce over a ``torch.distributed`` group
(``intreeger_allreduce``) and the train steps (``step``)."""
