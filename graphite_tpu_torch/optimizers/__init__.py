from .lm import LevenbergMarquardtOptions, LMResult, levenberg_marquardt

__all__ = ["LevenbergMarquardtOptions", "LMResult", "levenberg_marquardt"]
