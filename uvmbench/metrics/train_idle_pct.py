"""Device, under a training window: the share of the traced window with
nothing running on the card, in percent."""
from uvmbench.metrics.device_idle_pct import read  # noqa: F401
