"""device_idle_pct.kv: the device's idle share of the traced window, in
the cells that report ``ops_per_s`` (``pbench.trace.idle_pct``)."""

from pbench.trace import idle_pct as read  # noqa: F401
