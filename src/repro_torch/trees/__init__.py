from repro_torch.trees.cart import TreeArrays

__all__ = ["TreeArrays"]
