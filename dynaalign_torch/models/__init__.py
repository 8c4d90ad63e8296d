from .pipeline import nw_rescore_pairs  # noqa: F401
