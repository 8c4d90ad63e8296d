from .datasets import load_dataset, load_sequences  # noqa: F401
