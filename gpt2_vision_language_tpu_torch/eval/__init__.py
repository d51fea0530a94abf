from .hellaswag import HellaSwagEvaluator, iterate_examples, most_likely_row, render_example
from .cider import CiderScorer, cider_score
from .caption_eval import evaluate_captions
from .meteor import meteor_score

__all__ = ["HellaSwagEvaluator", "iterate_examples", "most_likely_row", "render_example",
           "CiderScorer", "cider_score", "evaluate_captions", "meteor_score"]
