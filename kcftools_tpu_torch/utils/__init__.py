from .logger import Logger
from . import javafmt
from . import jhash

__all__ = ["Logger", "javafmt", "jhash"]
