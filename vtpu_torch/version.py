"""Version metadata (vtpu/version.py; reference: pkg/version/version.go:1-37)."""

__version__ = "0.1.0"
