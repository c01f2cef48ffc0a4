"""Sandboxed expression/mini-program evaluation for agent tools.

Reference: NeuronAgent's code tool + sandbox/validator
(NeuronAgent/internal/tools/registry.go:30-33, sandbox.go). The Go
reference shells out to a sandboxed interpreter; here we interpret a
restricted Python AST directly — no exec/eval, no imports, no attribute
access, explicit step and magnitude budgets — so a hostile expression
can neither execute arbitrary code nor pin the CPU (e.g. ``9**9**9**9``).

The port's own copy of ``neurondb_tpu/utils/safeeval.py``: that module
imports no jax, but the port imports nothing of the JAX package, so it
keeps this one, unchanged in behaviour.
"""

from __future__ import annotations

import ast
import math
from typing import Any, Dict, Optional

__all__ = ["SafeEvalError", "safe_eval", "safe_exec"]


class SafeEvalError(ValueError):
    pass


_MAX_STEPS = 10_000
_MAX_INT_BITS = 512
_MAX_ABS = 1e100
_MAX_SEQ = 10_000
_MAX_STR = 100_000
_MAX_POW_EXP = 128

_BIN_OPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
}

_CMP_OPS = {
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
    ast.In: lambda a, b: a in b,
    ast.NotIn: lambda a, b: a not in b,
}

_SAFE_FUNCS: Dict[str, Any] = {
    "abs": abs, "min": min, "max": max, "len": len, "sum": sum,
    "round": round, "int": int, "float": float, "str": str, "bool": bool,
    "sorted": sorted, "list": list, "tuple": tuple, "set": set,
    "range": lambda *a: range(*a), "enumerate": enumerate, "zip": zip,
    "any": any, "all": all, "divmod": divmod,
    "sqrt": math.sqrt, "log": math.log, "exp": math.exp,
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "floor": math.floor, "ceil": math.ceil,
    "pi": math.pi, "e": math.e,
}


def _check(value: Any) -> Any:
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value.bit_length() > _MAX_INT_BITS:
        raise SafeEvalError("integer too large")
    if isinstance(value, float) and (math.isinf(value)
                                     or abs(value) > _MAX_ABS):
        raise SafeEvalError("float overflow")
    if isinstance(value, str) and len(value) > _MAX_STR:
        raise SafeEvalError("string too long")
    if isinstance(value, (list, tuple, set, dict)) and len(value) > _MAX_SEQ:
        raise SafeEvalError("sequence too long")
    return value


class _Interp:
    def __init__(self, env: Dict[str, Any], max_steps: int = _MAX_STEPS):
        self.env = dict(env)
        self.steps = 0
        self.max_steps = max_steps

    def tick(self) -> None:
        self.steps += 1
        if self.steps > self.max_steps:
            raise SafeEvalError("step budget exceeded")

    # ---- expressions ----
    def ev(self, node: ast.AST) -> Any:
        self.tick()
        if isinstance(node, ast.Expression):
            return self.ev(node.body)
        if isinstance(node, ast.Constant):
            if node.value is None or isinstance(
                    node.value, (bool, int, float, str)):
                return _check(node.value)
            raise SafeEvalError(f"constant {type(node.value).__name__} "
                                "not allowed")
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in _SAFE_FUNCS:
                return _SAFE_FUNCS[node.id]
            raise SafeEvalError(f"unknown name {node.id!r}")
        if isinstance(node, ast.BinOp):
            a, b = self.ev(node.left), self.ev(node.right)
            if isinstance(node.op, ast.Pow):
                if not isinstance(b, (int, float)) or abs(b) > _MAX_POW_EXP:
                    raise SafeEvalError("exponent out of range")
                if isinstance(a, int) and isinstance(b, int) and b >= 0:
                    if a.bit_length() * max(b, 1) > _MAX_INT_BITS:
                        raise SafeEvalError("pow result too large")
                return _check(a ** b)
            op = _BIN_OPS.get(type(node.op))
            if op is None:
                raise SafeEvalError(
                    f"operator {type(node.op).__name__} not allowed")
            if isinstance(node.op, ast.Mult) and (
                    isinstance(a, (str, list, tuple))
                    or isinstance(b, (str, list, tuple))):
                seq, n = (a, b) if isinstance(b, int) else (b, a)
                if isinstance(n, int) and len(seq) * max(n, 0) > _MAX_SEQ:
                    raise SafeEvalError("sequence repetition too large")
            return _check(op(a, b))
        if isinstance(node, ast.UnaryOp):
            v = self.ev(node.operand)
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return +v
            if isinstance(node.op, ast.Not):
                return not v
            raise SafeEvalError("unary operator not allowed")
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                v: Any = True
                for x in node.values:
                    v = self.ev(x)
                    if not v:
                        return v
                return v
            v = False
            for x in node.values:
                v = self.ev(x)
                if v:
                    return v
            return v
        if isinstance(node, ast.Compare):
            left = self.ev(node.left)
            for op, rhs in zip(node.ops, node.comparators):
                fn = _CMP_OPS.get(type(op))
                if fn is None:
                    raise SafeEvalError("comparison not allowed")
                right = self.ev(rhs)
                if not fn(left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return self.ev(node.body) if self.ev(node.test) \
                else self.ev(node.orelse)
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name):
                raise SafeEvalError("only direct calls to whitelisted "
                                    "functions are allowed")
            fn = _SAFE_FUNCS.get(node.func.id)
            if fn is None or not callable(fn):
                raise SafeEvalError(f"function {node.func.id!r} not allowed")
            if node.keywords:
                raise SafeEvalError("keyword arguments not allowed")
            args = [self.ev(a) for a in node.args]
            if node.func.id == "range":
                span = args[-1] if len(args) == 1 else args[1] - args[0]
                if abs(span) > _MAX_SEQ:
                    raise SafeEvalError("range too large")
            return _check(fn(*args))
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            vals = [self.ev(x) for x in node.elts]
            kind = {ast.List: list, ast.Tuple: tuple, ast.Set: set}
            return _check(kind[type(node)](vals))
        if isinstance(node, ast.Dict):
            if any(k is None for k in node.keys):
                raise SafeEvalError("dict unpacking not allowed")
            return _check({self.ev(k): self.ev(v)
                           for k, v in zip(node.keys, node.values)})
        if isinstance(node, ast.Subscript):
            obj = self.ev(node.value)
            if isinstance(node.slice, ast.Slice):
                lo = self.ev(node.slice.lower) if node.slice.lower else None
                hi = self.ev(node.slice.upper) if node.slice.upper else None
                st = self.ev(node.slice.step) if node.slice.step else None
                return _check(obj[lo:hi:st])
            return _check(obj[self.ev(node.slice)])
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            out = []
            self._comp(node.generators, 0, node.elt, out)
            if isinstance(node, ast.SetComp):
                return _check(set(out))
            return _check(out)
        raise SafeEvalError(f"syntax {type(node).__name__} not allowed")

    def _comp(self, gens, gi, elt, out) -> None:
        if gi == len(gens):
            self.tick()
            out.append(self.ev(elt))
            if len(out) > _MAX_SEQ:
                raise SafeEvalError("comprehension too large")
            return
        gen = gens[gi]
        if gen.is_async:
            raise SafeEvalError("async not allowed")
        if not isinstance(gen.target, ast.Name):
            raise SafeEvalError("comprehension target must be a name")
        for v in self.ev(gen.iter):
            self.tick()
            self.env[gen.target.id] = v
            if all(self.ev(c) for c in gen.ifs):
                self._comp(gens, gi + 1, elt, out)

    # ---- statements (for safe_exec mini-programs) ----
    def ex(self, node: ast.stmt) -> Optional[Any]:
        self.tick()
        if isinstance(node, ast.Expr):
            return self.ev(node.value)
        if isinstance(node, ast.Assign):
            if len(node.targets) != 1 or not isinstance(
                    node.targets[0], ast.Name):
                raise SafeEvalError("only simple assignment allowed")
            self.env[node.targets[0].id] = self.ev(node.value)
            return None
        if isinstance(node, ast.AugAssign):
            if not isinstance(node.target, ast.Name):
                raise SafeEvalError("only simple assignment allowed")
            cur = self.env.get(node.target.id)
            if cur is None and node.target.id not in self.env:
                raise SafeEvalError(f"unknown name {node.target.id!r}")
            synth = ast.BinOp(left=ast.Constant(cur), op=node.op,
                              right=node.value)
            ast.copy_location(synth, node)
            ast.fix_missing_locations(synth)
            self.env[node.target.id] = self.ev(synth)
            return None
        if isinstance(node, ast.If):
            body = node.body if self.ev(node.test) else node.orelse
            last = None
            for st in body:
                last = self.ex(st)
            return last
        if isinstance(node, ast.For):
            if not isinstance(node.target, ast.Name):
                raise SafeEvalError("for target must be a name")
            last = None
            for v in self.ev(node.iter):
                self.tick()
                self.env[node.target.id] = v
                for st in node.body:
                    last = self.ex(st)
            return last
        if isinstance(node, ast.While):
            last = None
            while self.ev(node.test):
                self.tick()
                for st in node.body:
                    last = self.ex(st)
            return last
        raise SafeEvalError(f"statement {type(node).__name__} not allowed")


def safe_eval(expr: str, env: Optional[Dict[str, Any]] = None,
              max_steps: int = _MAX_STEPS) -> Any:
    """Evaluate one restricted expression. Raises SafeEvalError."""
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise SafeEvalError(f"syntax error: {e.msg}") from None
    return _Interp(env or {}, max_steps).ev(tree)


def safe_exec(program: str, env: Optional[Dict[str, Any]] = None,
              max_steps: int = _MAX_STEPS) -> Any:
    """Run a restricted mini-program (assignments, if/for/while,
    expressions); returns the value of the last expression statement."""
    try:
        tree = ast.parse(program, mode="exec")
    except SyntaxError as e:
        raise SafeEvalError(f"syntax error: {e.msg}") from None
    interp = _Interp(env or {}, max_steps)
    last = None
    for st in tree.body:
        v = interp.ex(st)
        if v is not None:
            last = v
    return last
