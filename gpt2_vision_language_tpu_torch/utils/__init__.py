from .trees import fmt_count, tree_bytes, tree_size

__all__ = ["tree_size", "tree_bytes", "fmt_count"]
