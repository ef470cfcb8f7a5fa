"""Host-side helpers."""

from .profiling import add_profile_event, instrument_scope, switch_profile  # noqa: F401
