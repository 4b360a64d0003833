from .flags import FLAGS, define_flag

__all__ = ["FLAGS", "define_flag"]
