from .lm import (
    LevenbergMarquardtOptions,
    LMResult,
    levenberg_marquardt,
    levenberg_marquardt2,
)
from .gradient_descent import GradientDescentOptions, gradient_descent
from .adam import AdamOptions, adam

__all__ = [
    "LevenbergMarquardtOptions",
    "LMResult",
    "levenberg_marquardt",
    "levenberg_marquardt2",
    "GradientDescentOptions",
    "gradient_descent",
    "AdamOptions",
    "adam",
]
