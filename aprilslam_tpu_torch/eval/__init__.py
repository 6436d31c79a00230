from .ate import ate_eval

__all__ = ["ate_eval"]
