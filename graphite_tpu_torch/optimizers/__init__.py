from .lm import (
    LevenbergMarquardtOptions,
    LMResult,
    levenberg_marquardt,
    levenberg_marquardt2,
)

__all__ = ["LevenbergMarquardtOptions", "LMResult", "levenberg_marquardt",
           "levenberg_marquardt2"]
