from .device import resolve_device
from .io import dump_json, load_json
from .logging import get_logger

__all__ = ["dump_json", "get_logger", "load_json", "resolve_device"]
