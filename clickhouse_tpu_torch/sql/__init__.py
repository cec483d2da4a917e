from . import ast
from .lexer import tokenize
from .parser import parse, parse_expression
