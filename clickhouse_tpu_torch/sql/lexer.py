"""SQL lexer (analog of src/Parsers/Lexer.h:108).

Produces a flat token list; keywords stay as bare-word tokens and are matched
case-insensitively by the parser, mirroring the reference's approach.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..core.errors import ParseError

__all__ = ["Token", "tokenize"]


@dataclasses.dataclass
class Token:
    kind: str       # word | number | string | op | end
    text: str
    pos: int

    def is_kw(self, *kws: str) -> bool:
        return self.kind == "word" and self.text.upper() in kws


# zero-width / BOM / joiner characters that str.isspace() misses but the
# reference lexer skips (01280_unicode_whitespaces_lexer)
_FORMAT_CHARS = "﻿​‌‍⁠­"

_OPS = [
    "<=>", "==", "!=", "<>", "<=", ">=", "->", "||", "::",
    "=", "<", ">", "+", "-", "*", "/", "%", "(", ")", ",", ".", ";",
    "[", "]", "?", ":", "@", "{", "}",
]


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace() or c in _FORMAT_CHARS:
            i += 1
            continue
        # comments (--, #, #! to end of line — reference Lexer.cpp accepts
        # shell-style hash comments)
        if sql.startswith("--", i) or c == "#":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise ParseError(f"Unterminated comment at {i}")
            i = j + 2
            continue
        # strings
        if c == "'":
            start = i
            text, i = _read_quoted(sql, i, "'")
            tokens.append(Token("string", text, start))
            continue
        if c == "`" or c == '"':
            start = i
            text, i = _read_quoted(sql, i, c)
            tokens.append(Token("word", text, start))
            continue
        # numbers (incl. 0x hex with p-exponent, 0b binary, _ digit
        # separators — reference Lexer.cpp quietly accepts all three)
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            if sql.startswith(("0x", "0X"), i):
                j = i + 2
                while j < n and (sql[j] in "0123456789abcdefABCDEF_"
                                 or sql[j] in "pP"
                                 or (sql[j] in "+-" and sql[j - 1] in "pP")):
                    j += 1
            elif sql.startswith(("0b", "0B"), i) and i + 2 < n \
                    and sql[i + 2] in "01":
                j = i + 2
                while j < n and sql[j] in "01_":
                    j += 1
            else:
                while j < n and (sql[j].isdigit() or sql[j] in ".eE"
                                 or (sql[j] in "+-" and sql[j - 1] in "eE")
                                 or (sql[j] == "_" and j + 1 < n
                                     and sql[j + 1].isdigit())):
                    j += 1
            # digit-leading identifier (02581_trips, 01760_db): the number
            # run continues with identifier chars -> one word token
            if j < n and (sql[j].isalpha() or sql[j] in "_$") \
                    and not sql.startswith(("0x", "0X"), i):
                while j < n and (sql[j].isalnum() or sql[j] in "_$"):
                    j += 1
                tokens.append(Token("word", sql[i:j], i))
            else:
                tokens.append(Token("number", sql[i:j], i))
            i = j
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_" or c == "$":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_" or sql[j] == "$"):
                j += 1
            tokens.append(Token("word", sql[i:j], i))
            i = j
            continue
        # operators
        for op in _OPS:
            if sql.startswith(op, i):
                tokens.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise ParseError(f"Unexpected character {c!r} at position {i}")
    tokens.append(Token("end", "", n))
    return tokens


def _read_quoted(sql: str, i: int, quote: str):
    out = []
    j = i + 1
    n = len(sql)
    while j < n:
        c = sql[j]
        if c == "\\" and j + 1 < n and quote == "'":
            esc = sql[j + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r", "0": "\0",
                        "\\": "\\", "'": "'", '"': '"', "`": "`"}.get(esc, esc))
            j += 2
            continue
        if c == quote:
            if j + 1 < n and sql[j + 1] == quote:  # doubled quote escape
                out.append(quote)
                j += 2
                continue
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ParseError(f"Unterminated quoted token starting at {i}")
