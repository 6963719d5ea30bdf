"""C code generation for the host-C backends, numpy only: the paper's
if-else C (``c_emitter``), the ragged-layout table walk
(``table_emitter``), the QuickScorer bitvector scorer
(``bitvector_emitter``) and the Sec. IV-D timing harness
(``native_bench``)."""
