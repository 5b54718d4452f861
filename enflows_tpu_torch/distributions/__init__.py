from .base import FlowDistribution, std_normal_logpdf, std_normal_logpdf_sum

__all__ = ["FlowDistribution", "std_normal_logpdf", "std_normal_logpdf_sum"]
