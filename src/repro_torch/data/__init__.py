from .datasets import Dataset, REGISTRY, load

__all__ = ["Dataset", "REGISTRY", "load"]
