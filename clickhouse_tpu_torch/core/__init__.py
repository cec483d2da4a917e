from . import dtypes
from .block import Block
from .column import Column, Dictionary, column_from_numpy, pad_to, PAD_MULTIPLE
from .settings import Settings
from . import errors
