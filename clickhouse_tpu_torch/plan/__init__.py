from . import logical
from .analyzer import Analyzer
from .optimizer import optimize_plan
