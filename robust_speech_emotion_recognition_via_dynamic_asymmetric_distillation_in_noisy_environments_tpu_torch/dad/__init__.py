from .train_step import make_eval_step

__all__ = ["make_eval_step"]
