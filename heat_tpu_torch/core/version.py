"""Version information for heat_tpu_torch: heat_tpu's version triple, so the two
packages report the same ``__version__``."""

major: int = 0
"""Major version number."""
minor: int = 2
"""Minor version number."""
micro: int = 0
"""Micro (patch) version number."""
extension: str = "dev0"
"""Pre-release tag (PEP 440 suffix, e.g. ``dev0``; empty for releases)."""

if not extension:
    __version__ = f"{major}.{minor}.{micro}"
else:
    __version__ = f"{major}.{minor}.{micro}.{extension}"
