from .date_time import DateTimeNamespace
from .string import StringNamespace
from .numerical import NumericalNamespace
from .binary import BinaryNamespace

__all__ = ["DateTimeNamespace", "StringNamespace", "NumericalNamespace", "BinaryNamespace"]
