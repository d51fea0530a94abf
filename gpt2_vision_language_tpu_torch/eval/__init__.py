from .hellaswag import HellaSwagEvaluator, iterate_examples, most_likely_row, render_example

__all__ = ["HellaSwagEvaluator", "iterate_examples", "most_likely_row", "render_example"]
