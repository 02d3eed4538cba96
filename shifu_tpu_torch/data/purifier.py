"""DataPurifier — row filtering by user expressions, vectorized.

The port's copy of `shifu_tpu/data/purifier.py`. The JAX package
evaluates the normalized expression with ``pandas.eval(engine="python",
parser="pandas")``; the port has no pandas, so a small `ast` evaluator
over numpy columns gives the same answers for what filter expressions
use and nothing more:

- `and` / `or` / `not` (and `&` / `|`, which the pandas parser gives the
  precedence of `and` / `or`) act elementwise;
- comparisons, chained ones included (``1 < a <= 5``), arithmetic
  (``+ - * / // % **``, unary ``-`` / ``+``) and string equality;
- a referenced column is coerced to numeric when over 90 % of it
  parses (`reader.to_numeric`, pandas' rules), else it stays strings;
- any other syntax raises `ValueError`.

The JEXL rewrite (`_normalize_expr`) is the JAX package's, unchanged.
"""

from __future__ import annotations

import ast
import io
import operator
import re
import tokenize

import numpy as np

from shifu_tpu_torch.data.reader import Table, to_numeric

_STRING_LIT = re.compile(r"""("([^"\\]|\\.)*"|'([^'\\]|\\.)*')""")


def _normalize_expr(expr: str) -> str:
    """Rewrite JEXL operators to Python, skipping quoted string literals
    so values like "ne" or "a&&b" are never mangled."""
    def fix(segment: str) -> str:
        s = segment.replace("&&", " and ").replace("||", " or ")
        # JEXL 'eq'/'ne'/'lt'/'gt'/'le'/'ge' word operators (must stand
        # alone between spaces to avoid column names like 'le')
        for word, op in (("eq", "=="), ("ne", "!="), ("lt", "<"),
                         ("le", "<="), ("gt", ">"), ("ge", ">=")):
            s = re.sub(rf"(?<=\s){word}(?=\s)", op, s)
        return s

    out, last = [], 0
    for m in _STRING_LIT.finditer(expr):
        out.append(fix(expr[last:m.start()]))
        out.append(m.group(0))
        last = m.end()
    out.append(fix(expr[last:]))
    return "".join(out).strip()


def _replace_booleans(expr: str) -> str:
    """`&` → `and`, `|` → `or` outside string literals — the pandas
    parser's rewrite, which gives them the precedence of and/or."""
    toks = []
    for tok in tokenize.generate_tokens(io.StringIO(expr).readline):
        if tok.type == tokenize.OP and tok.string in ("&", "|"):
            toks.append((tokenize.NAME,
                         "and" if tok.string == "&" else "or"))
        else:
            toks.append((tok.type, tok.string))
    return tokenize.untokenize(toks)


_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.truediv,
           ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod,
           ast.Pow: operator.pow}
_CMPOPS = {ast.Eq: operator.eq, ast.NotEq: operator.ne,
           ast.Lt: operator.lt, ast.LtE: operator.le,
           ast.Gt: operator.gt, ast.GtE: operator.ge}


def _is_str(v) -> bool:
    return isinstance(v, str) or (isinstance(v, np.ndarray)
                                  and v.dtype.kind in "US")


def _compare(op, a, b):
    """Elementwise comparison; a string against a number is unequal
    everywhere (pandas' object comparison) and unordered (raises)."""
    if _is_str(a) != _is_str(b) and op in (ast.Eq, ast.NotEq):
        return np.full(np.broadcast_shapes(np.shape(a), np.shape(b)),
                       op is ast.NotEq)
    return np.asarray(_CMPOPS[op](a, b))


def _not(v):
    v = np.asarray(v)
    return ~v if v.dtype == bool else np.logical_not(v)


class _Evaluator(ast.NodeVisitor):
    def __init__(self, names):
        self.names = names

    def generic_visit(self, node):
        raise ValueError(f"unsupported syntax: {type(node).__name__}")

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_Name(self, node):
        if node.id in self.names:
            return self.names[node.id]
        if node.id in ("True", "False"):
            return node.id == "True"
        raise ValueError(f"name {node.id!r} is not defined")

    def visit_Constant(self, node):
        if isinstance(node.value, (bool, int, float, str)):
            return node.value
        raise ValueError(f"unsupported constant {node.value!r}")

    def visit_BoolOp(self, node):
        vals = [self.visit(v) for v in node.values]
        fn = operator.and_ if isinstance(node.op, ast.And) else operator.or_
        out = np.asarray(vals[0])
        for v in vals[1:]:
            out = fn(out, np.asarray(v))
        return out

    def visit_UnaryOp(self, node):
        v = self.visit(node.operand)
        if isinstance(node.op, (ast.Not, ast.Invert)):
            return _not(v)
        if isinstance(node.op, ast.USub):
            return -np.asarray(v) if isinstance(v, np.ndarray) else -v
        if isinstance(node.op, ast.UAdd):
            return v
        raise ValueError(f"unsupported operator {type(node.op).__name__}")

    def visit_BinOp(self, node):
        fn = _BINOPS.get(type(node.op))
        if fn is None:
            raise ValueError(
                f"unsupported operator {type(node.op).__name__}")
        return fn(self.visit(node.left), self.visit(node.right))

    def visit_Compare(self, node):
        left = self.visit(node.left)
        out = None
        for op, comp in zip(node.ops, node.comparators):
            if type(op) not in _CMPOPS:
                raise ValueError(
                    f"unsupported comparison {type(op).__name__}")
            right = self.visit(comp)
            r = _compare(type(op), left, right)
            out = r if out is None else out & r
            left = right
        return out


class DataPurifier:
    def __init__(self, filter_expressions: str):
        self.raw = (filter_expressions or "").strip()
        self.expr = _normalize_expr(self.raw) if self.raw else ""

    def apply(self, df: Table) -> np.ndarray:
        """Boolean keep-mask over rows. Column refs resolve against the
        table; numeric-looking columns are coerced so `col > 5` works on
        string columns."""
        if not self.expr:
            return np.ones(len(df), dtype=bool)
        ns = {}
        for col in df.columns:
            if re.search(rf"\b{re.escape(col)}\b", self.expr):
                s = df[col]
                coerced = to_numeric(s) if s.dtype.kind in "US" \
                    else np.asarray(s)
                ok = (~np.isnan(coerced)).mean() if len(s) else 0.0
                ns[col] = coerced if ok > 0.9 or s.dtype.kind == "f" \
                    else s
        try:
            tree = ast.parse(_replace_booleans(self.expr).strip(),
                             mode="eval")
            result = _Evaluator(ns).visit(tree)
        except Exception as exc:
            raise ValueError(
                f"failed to evaluate filterExpressions {self.raw!r}: "
                f"{exc}") from exc
        if np.ndim(result) == 0:
            return np.full(len(df), bool(result))
        mask = np.asarray(result)
        if mask.dtype != bool:
            mask = mask.astype(bool)
        return mask
