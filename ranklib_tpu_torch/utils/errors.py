"""Error type for all fatal framework paths (copy of ranklib_tpu.utils.errors).

Mirrors the reference's single funnel exception (ref:
utilities/RankLibError.java:~10). The port's own class: code that catches
``ranklib_tpu``'s RankLibError does not catch this one, and vice versa.
"""


class RankLibError(RuntimeError):
    """Raised for any user-facing fatal error (bad flags, bad data, bad model)."""
