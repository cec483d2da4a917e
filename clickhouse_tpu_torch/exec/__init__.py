from .session import Session
from .result import Result
