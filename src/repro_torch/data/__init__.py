from .pipeline import DataConfig, SyntheticLM, make_dataset, unpack_to_rows

__all__ = ["DataConfig", "SyntheticLM", "make_dataset", "unpack_to_rows"]
