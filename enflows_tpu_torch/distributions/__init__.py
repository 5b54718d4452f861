from .base import FlowDistribution, std_normal_logpdf, std_normal_logpdf_sum
from .johnson_su import JohnsonSU

__all__ = ["FlowDistribution", "std_normal_logpdf", "std_normal_logpdf_sum",
           "JohnsonSU"]
