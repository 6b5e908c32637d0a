"""SQL tokenizer.

The port's own copy of ``gpu_olap_tpu/sql/tokenizer.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

The reference frontend leans on the ``sqlparser`` crate (``parser.rs:11``); that
crate does not exist here, so the frontend is a hand-written lexer + recursive
descent parser covering the dialect used across the reference's examples, tests
and benches (``examples/python_usage.py``, ``tests/integration_tests.rs``,
``benches/engine_bench.rs``).
"""

from __future__ import annotations

import dataclasses
from typing import List


class SqlError(ValueError):
    pass


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit", "offset",
    "join", "inner", "left", "right", "full", "outer", "cross", "on", "as",
    "and", "or", "not", "in", "between", "like", "is", "null", "distinct",
    "asc", "desc", "case", "when", "then", "else", "end", "cast", "true", "false",
    "union", "all", "with",
}

# multi-char operators first
OPERATORS = ["<>", "!=", ">=", "<=", "||", "=", "<", ">", "+", "-", "*", "/", "%",
             "(", ")", ",", ".", ";"]


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str   # "ident" | "keyword" | "number" | "string" | "op" | "eof"
    value: str
    pos: int


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise SqlError(f"Unterminated block comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlError(f"Unterminated string literal at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # escaped ''
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError(f"Unterminated quoted identifier at {i}")
            tokens.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    if j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                        seen_exp = True
                        j += 2
                    else:
                        break
                else:
                    break
            tokens.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            kind = "keyword" if word.lower() in KEYWORDS else "ident"
            tokens.append(Token(kind, word.lower() if kind == "keyword" else word, i))
            i = j
            continue
        matched = False
        for op in OPERATORS:
            if sql.startswith(op, i):
                tokens.append(Token("op", op, i))
                i += len(op)
                matched = True
                break
        if not matched:
            raise SqlError(f"Unexpected character {c!r} at position {i}")
    tokens.append(Token("eof", "", n))
    return tokens
