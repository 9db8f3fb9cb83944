"""psrlint checkers: the six rule implementations, re-cast for PyTorch
(counterpart: psrsigsim_tpu/analysis/checkers.py).

Every checker is a small AST pass over one module
(:class:`~psrsigsim_torch.analysis.core.ModuleContext`).  They share the
import-alias resolver, the hot-code reachability walk and the transitive
"derived from a tensor" tracking below; none of them imports torch — the
static claims are cross-checked on a device by
:mod:`psrsigsim_torch.analysis.trace_check` instead.

What the JAX package's rules say of a traced value, these say of a device
tensor: a Python branch, a coercion or a host transfer of one forces the
host to wait for the card (PSR101), as does handing one to numpy or scipy
(PSR102).  Heuristics (documented per rule in docs/torch/static_analysis.md):

* a value is a tensor when it comes from a ``torch.`` call (not one of the
  host-metadata calls such as ``torch.device`` or ``torch.finfo``), from a
  parameter annotated ``torch.Tensor``, or from an expression over such a
  value; ``x.shape``/``x.device``-style reads and ``x.numel()``-style
  calls are host metadata, never a sync;
* branching on ``_is_concrete(x)`` or on ``isinstance(x, torch.Tensor)``
  is the sanctioned concrete/device fork — np/scipy work inside the host
  branch is host-side by construction and exempt from PSR102 and PSR104;
* ``float(x)`` inside a ``try`` with a handler is the sanctioned probe and
  exempt from PSR101;
* ``stage_key``/``fold_in``/``split`` DERIVE threefry keys (utils/rng.py)
  and may be applied repeatedly to one root; samplers CONSUME keys and may
  see each key once (PSR103).
"""

from __future__ import annotations

import ast

from .core import Finding, RULES

__all__ = ["default_checkers"]

# calls that stage a function for repeated execution on the card: what
# they are given is hot code, like the reference's jit sites
_STAGING_WRAPPERS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.vmap", "torch.func.vmap", "functorch.vmap",
    "torch.cuda.make_graphed_callables",
}
# the port's program registries (runtime/programs.py, serve/programs.py)
# stage what a builder returns
_STAGING_METHODS = {"get_or_build"}
_TENSOR_PREFIX = "torch."
# torch calls whose result is host metadata, not a device tensor
_TORCH_HOST = {
    "torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.numel", "torch.get_default_dtype", "torch.result_type",
    "torch.promote_types", "torch.can_cast", "torch.is_grad_enabled",
    "torch.dtype", "torch.no_grad", "torch.inference_mode",
    "torch.Generator", "torch.get_num_threads", "torch.manual_seed",
}
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.",
                        "torch.distributed.", "torch.utils.",
                        "torch.profiler.", "torch.autograd.",
                        "torch.testing.", "torch.version.", "torch.set_")
# builtins whose result is a host value (a coercion among them is PSR101's
# finding, not a tensor)
_HOST_BUILTINS = {"isinstance", "len", "int", "float", "bool", "str",
                  "repr", "range", "hasattr", "type", "id", "callable"}
# factories that make a tensor on the host unless given ``device=``
_FACTORIES = {"torch.tensor", "torch.as_tensor", "torch.from_numpy",
              "torch.zeros", "torch.ones", "torch.full", "torch.empty",
              "torch.arange", "torch.linspace", "torch.eye"}
# tensor methods that return host values without a sync
_META_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                 "stride", "is_contiguous", "data_ptr", "get_device",
                 "is_floating_point", "is_complex", "storage_offset",
                 "type"}
# tensor methods that move a device tensor to the host (a sync each)
_HOST_TRANSFERS = {"item", "tolist", "cpu", "numpy"}
_RNG_DERIVERS = {"split", "fold_in", "stage_key", "next_key", "clone"}
_RNG_NONCONSUMING = {"key", "as_key", "key_data", "KeySequence",
                     "default_keys", "set_seed", "STAGES"}
_DTYPE_TOKENS = {
    "dtype", "float16", "bfloat16", "float32", "float64", "int8", "int16",
    "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool",
    "complex64", "complex128", "half", "float", "double", "long", "int",
    "short", "cfloat", "cdouble",
}
_TORCH_F64 = {"torch.float64", "torch.double", "torch.complex128",
              "torch.cdouble"}
_HOST_DATA_CONSTRUCTORS = {"torch.tensor", "torch.as_tensor"}
# methods that pin the dtype of what ``torch.from_numpy`` returns
_DTYPE_METHODS = {"float", "half", "bfloat16", "int", "long", "short",
                  "bool", "byte", "char"}


def _aliases(tree):
    """Map local names to canonical dotted import paths."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Resolver:
    def __init__(self, tree):
        self.aliases = _aliases(tree)
        # module-level ``_F32 = torch.float32``-style constants
        self.constants = {}
        for node in getattr(tree, "body", []):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                dotted = self.resolve(node.value)
                if dotted:
                    self.constants[node.targets[0].id] = dotted

    def dtype_like(self, node):
        """Whether ``node`` names a dtype (``torch.float32``, ``np.int16``,
        a module constant bound to one)."""
        if isinstance(node, ast.Name) and node.id in self.constants:
            dotted = self.constants[node.id]
        else:
            dotted = _dotted(node)
        return bool(dotted) and dotted.split(".")[-1] in _DTYPE_TOKENS

    def resolve(self, node):
        """Canonical dotted path of a Name/Attribute expr, or None."""
        dotted = _dotted(node)
        if dotted is None:
            return None
        first, _, rest = dotted.partition(".")
        base = self.aliases.get(first, first)
        return f"{base}.{rest}" if rest else base

    def call_name(self, call):
        return self.resolve(call.func) if isinstance(call, ast.Call) else None


def _is_tensor_call(resolved):
    """Whether a resolved call name makes a device tensor."""
    return (bool(resolved) and resolved.startswith(_TENSOR_PREFIX)
            and resolved not in _TORCH_HOST
            and not resolved.startswith(_TORCH_HOST_PREFIXES))


def _is_rng_module(resolved):
    """Whether a resolved call name is a function of the port's threefry
    module (``utils/rng.py``)."""
    return ".utils.rng." in "." + resolved or resolved.startswith("rng.")


def _walk_no_nested_defs(node):
    """Walk an AST subtree WITHOUT descending into nested function/class
    scopes (their bodies are visited when that scope is analyzed)."""
    stack = [node]
    first = True
    while stack:
        cur = stack.pop()
        if not first and isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                  ast.Lambda)
        ):
            continue
        first = False
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


# -- hot-code reachability -----------------------------------------------------

class _FunctionIndex:
    """All function-like scopes in a module + which are hot code."""

    def __init__(self, ctx, res):
        self.funcs = []
        self.by_name = {}
        self._collect(ctx.tree)
        self.reachable = self._reach(ctx, res)

    def _collect(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs.append(node)
                self.by_name.setdefault(node.name, node)
            elif isinstance(node, ast.Lambda):
                self.funcs.append(node)

    def _staged(self, arg):
        if isinstance(arg, ast.Lambda):
            return arg
        if isinstance(arg, ast.Name):
            return self.by_name.get(arg.id)
        return None

    def _roots(self, ctx, res):
        roots = set()
        if ctx.assume_jitted():
            for node in ctx.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    roots.add(node)
        for fn in self.funcs:
            for deco in getattr(fn, "decorator_list", []):
                target = deco.func if isinstance(deco, ast.Call) else deco
                name = res.resolve(target)
                if name in _STAGING_WRAPPERS:
                    roots.add(fn)
                elif (isinstance(deco, ast.Call)
                      and name in ("functools.partial", "partial")
                      and deco.args
                      and res.resolve(deco.args[0]) in _STAGING_WRAPPERS):
                    roots.add(fn)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if res.call_name(node) in _STAGING_WRAPPERS and node.args:
                staged = [self._staged(node.args[0])]
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _STAGING_METHODS):
                staged = [self._staged(a) for a in node.args[1:]]
            else:
                continue
            roots.update(fn for fn in staged if fn is not None)
        return roots

    def _reach(self, ctx, res):
        """Roots, what they call by name, and the closures they return
        (a builder's program, a factory's kernel), to a fixpoint."""
        reachable = set(self._roots(ctx, res))
        frontier = list(reachable)
        while frontier:
            fn = frontier.pop()
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            nested = {n.name: n for n in body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
            for stmt in body:
                for node in ast.walk(stmt):
                    callee = None
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Name)):
                        callee = self.by_name.get(node.func.id)
                    elif (isinstance(node, ast.Return)
                          and isinstance(node.value, ast.Name)):
                        callee = nested.get(node.value.id)
                    if callee is not None and callee not in reachable:
                        reachable.add(callee)
                        frontier.append(callee)
        return reachable


def _resolver_of(ctx):
    """Per-module resolver, built once and shared by every checker."""
    res = ctx.cache.get("resolver")
    if res is None:
        res = ctx.cache["resolver"] = _Resolver(ctx.tree)
    return res


def _index_of(ctx):
    """Per-module function index + hot-code reachability, built once."""
    idx = ctx.cache.get("func_index")
    if idx is None:
        idx = ctx.cache["func_index"] = _FunctionIndex(ctx, _resolver_of(ctx))
    return idx


def _guarded_of(ctx):
    """Per-module ``_is_concrete``-guarded node ids, built once (used by
    both PSR102 and PSR104)."""
    ids = ctx.cache.get("guarded_ids")
    if ids is None:
        ids = ctx.cache["guarded_ids"] = _concrete_guarded_ids(
            ctx.tree, _resolver_of(ctx))
    return ids


def _derived_of(ctx, fn):
    """Per-function names that hold device tensors, built once (PSR101,
    PSR102 and PSR104 read it)."""
    table = ctx.cache.setdefault("derived", {})
    names = table.get(id(fn))
    if names is None:
        names = table[id(fn)] = _tensor_names(fn, _resolver_of(ctx))
    return names


def _func_line(fn):
    return getattr(fn, "lineno", 0)


def _host_test(test, res):
    """Which branch of ``test`` runs on host values only: ``"body"`` for
    ``_is_concrete(x)``, ``not isinstance(x, torch.Tensor)`` and
    ``isinstance(x, np.ndarray)`` (or a conjunction holding one),
    ``"orelse"`` for ``isinstance(x, torch.Tensor)``, else None."""
    def isinstance_of(node):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance" and len(node.args) == 2):
            types = node.args[1]
            elts = types.elts if isinstance(types, ast.Tuple) else [types]
            return {(res.resolve(t) or "").split(".")[-1] for t in elts}
        return None

    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return ("body" if any(_host_test(v, res) == "body"
                              for v in test.values) else None)
    if (isinstance(test, ast.Call)
            and (res.call_name(test) or "").split(".")[-1] == "_is_concrete"):
        return "body"
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        types = isinstance_of(test.operand)
        return "body" if types and "Tensor" in types else None
    types = isinstance_of(test)
    if types and "Tensor" in types:
        return "orelse"
    if types and "ndarray" in types:
        return "body"
    return None


def _concrete_guarded_ids(root, res):
    """ids of nodes in the host branch of a concrete/tensor fork (see
    :func:`_host_test`; the reference's ``if _is_concrete(...)`` among
    them): host numpy/float64 work there runs on host values by
    construction."""
    exempt = set()
    for node in ast.walk(root):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        side = _host_test(node.test, res)
        if side is None:
            continue
        branch = getattr(node, side)
        for stmt in branch if isinstance(branch, list) else [branch]:
            for sub in ast.walk(stmt):
                exempt.add(id(sub))
    return exempt


def _body_stmts(fn):
    return fn.body if isinstance(fn.body, list) else [ast.Expr(fn.body)]


# -- device tensors ------------------------------------------------------------

# attribute reads that are host metadata on a tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "itemsize", "nbytes", "size", "is_sparse"}


def _is_tensor_annotation(node, res):
    if node is None:
        return False
    name = res.resolve(node) or ""
    return name.split(".")[-1] == "Tensor"


def _tensor_names(fn, res):
    """Names of ``fn``'s scope that hold device tensors: parameters
    annotated ``torch.Tensor``, then assignment targets whose value is a
    tensor expression, to a FIXPOINT (the walk order is arbitrary, and
    ``b = a + 1`` must become a tensor whenever ``a = torch.zeros(3)``
    does, whichever assignment is seen first)."""
    derived = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _is_tensor_annotation(a.annotation, res):
                derived.add(a.arg)
    assigns = [n for n in _walk_no_nested_defs(fn)
               if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if node.value is None or not _is_tensor(node.value, res,
                                                    derived):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                for name in _bound_names(tgt):
                    if name not in derived:
                        derived.add(name)
                        changed = True
    return derived


def _bound_names(target):
    """The names an assignment target binds or updates: ``a`` for ``a``
    and ``a[i] = ...`` (never the index expressions; an attribute store
    ``a.x = ...`` leaves ``a`` what it was), each element of a tuple
    target."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for el in target.elts for n in _bound_names(el)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    if isinstance(target, ast.Subscript):
        return _bound_names(target.value)
    return []


def _is_tensor(expr, res, derived):
    """Whether evaluating ``expr`` yields (or reads) a device tensor.

    Deliberately not counted: ``x.shape``/``x.device``-style metadata
    reads and ``x.numel()``-style calls, the host copies ``x.item()``/
    ``x.tolist()``/``x.cpu()``/``x.numpy()`` (the transfer itself is the
    finding), ``x is None`` identity checks, and any expression containing
    an ``isinstance`` call (the static type-dispatch fork)."""
    if isinstance(expr, ast.Attribute) and expr.attr in _STATIC_ATTRS:
        return False
    if isinstance(expr, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops
    ):
        return False
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name) and expr.func.id in _HOST_BUILTINS:
            return False
        name = res.call_name(expr) or ""
        if name.startswith(("numpy.", "scipy.")):
            return False     # a host array (PSR102 flags a tensor argument)
        if name in _FACTORIES and not any(kw.arg == "device"
                                          for kw in expr.keywords):
            return False     # made on the host: no device, no sync
        if name.startswith(_TENSOR_PREFIX):
            return _is_tensor_call(name)
        if (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _META_METHODS | _HOST_TRANSFERS):
            return False
    if isinstance(expr, ast.Name):
        return expr.id in derived
    if isinstance(expr, (ast.Lambda, ast.Constant)):
        return False
    return any(_is_tensor(child, res, derived)
               for child in ast.iter_child_nodes(expr))


def _is_tensor_test(expr, res, derived):
    """A branch test containing ``isinstance(...)`` anywhere is the static
    type-dispatch fork — never flagged as a whole."""
    for node in ast.walk(expr):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance"):
            return False
    return _is_tensor(expr, res, derived)


# -- PSR101: host syncs in hot code --------------------------------------------

class TraceSafetyChecker:
    rule = "PSR101"

    def check(self, ctx):
        res = _resolver_of(ctx)
        index = _index_of(ctx)
        severity = RULES[self.rule][0]
        for fn in index.funcs:
            if fn not in index.reachable:
                continue
            yield from self._check_fn(ctx, res, fn, severity)

    def _check_fn(self, ctx, res, fn, severity):
        derived = _derived_of(ctx, fn)
        in_probe_try = set()
        in_test = set()
        for node in _walk_no_nested_defs(fn):
            if isinstance(node, ast.Try) and node.handlers:
                for sub in ast.walk(node):
                    in_probe_try.add(id(sub))
            if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                for sub in ast.walk(node.test):
                    in_test.add(id(sub))

        def finding(node, msg):
            return Finding(ctx.rel, node.lineno, node.col_offset, self.rule,
                           msg, severity, func_line=_func_line(fn))

        for node in _walk_no_nested_defs(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if _is_tensor_test(node.test, res, derived):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "if-else"}[type(node)]
                    yield finding(
                        node, f"`{kind}` branches on a device tensor in hot "
                              "code: the host waits for the card; use "
                              "torch.where or hoist to a host argument")
            elif isinstance(node, ast.Assert):
                if _is_tensor_test(node.test, res, derived):
                    yield finding(
                        node, "`assert` on a device tensor syncs the host "
                              "with the card; validate on host values")
            elif isinstance(node, (ast.BoolOp, ast.UnaryOp)):
                if (id(node) not in in_test
                        and (isinstance(node, ast.BoolOp)
                             or isinstance(node.op, ast.Not))
                        and _is_tensor_test(node, res, derived)):
                    kind = ("not" if isinstance(node, ast.UnaryOp) else
                            "and" if isinstance(node.op, ast.And) else "or")
                    yield finding(
                        node, f"`{kind}` takes the truth value of a device "
                              "tensor in hot code (a host sync); use "
                              "torch.logical_and/or/not")
            elif isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Name)
                        and node.func.id in ("float", "int", "bool")
                        and len(node.args) == 1
                        and id(node) not in in_probe_try
                        and _is_tensor(node.args[0], res, derived)):
                    yield finding(
                        node, f"`{node.func.id}()` of a device tensor copies "
                              "it to the host (a sync) in hot code")
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in _HOST_TRANSFERS
                      and not node.args
                      and _is_tensor(node.func.value, res, derived)):
                    yield finding(
                        node, f"`.{node.func.attr}()` of a device tensor "
                              "forces a host round-trip in hot code")


# -- PSR102: host numpy/scipy on tensors ---------------------------------------

class HostNumpyChecker:
    rule = "PSR102"

    def check(self, ctx):
        if not ctx.in_device_modules():
            return
        res = _resolver_of(ctx)
        index = _index_of(ctx)
        severity = RULES[self.rule][0]
        allow = set(ctx.config.numpy_allow)
        exempt = _guarded_of(ctx)
        for fn in index.funcs:
            derived = _derived_of(ctx, fn)
            for node in _walk_no_nested_defs(fn):
                if not isinstance(node, ast.Call) or id(node) in exempt:
                    continue
                name = res.call_name(node)
                if not name or not name.startswith(("numpy.", "scipy.")):
                    continue
                if name.split(".")[-1] in allow:
                    continue
                args = list(node.args) + [kw.value for kw in node.keywords]
                if not any(_is_tensor(a, res, derived) for a in args):
                    continue
                yield Finding(
                    ctx.rel, node.lineno, node.col_offset, self.rule,
                    f"host call `{name}` on a device tensor copies it to "
                    "the host (use the torch op, or move to config/staging "
                    "time)", severity, func_line=_func_line(fn))


# -- PSR103: threefry key discipline -------------------------------------------

_RANK = {"fresh": 0, "derived": 1, "sunk": 2}


class RngReuseChecker:
    rule = "PSR103"

    def check(self, ctx):
        res = _resolver_of(ctx)
        index = _index_of(ctx)
        severity = RULES[self.rule][0]
        sinks = set(ctx.config.rng_sinks)
        seen = set()
        for fn in index.funcs:
            findings = []
            self._scan_block(_body_stmts(fn), {}, res, sinks, findings,
                             ctx, fn, severity)
            for f in findings:
                key = (f.line, f.col, f.message)
                if key not in seen:
                    seen.add(key)
                    yield f

    # one statement's rng events, in source order, no nested scopes
    def _events(self, stmt, res, sinks):
        events = []
        for node in _walk_no_nested_defs(stmt):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = res.call_name(node)
            if not name:
                continue
            last = name.split(".")[-1]
            arg = node.args[0]
            if not isinstance(arg, ast.Name):
                continue
            if _is_rng_module(name):
                if last in _RNG_DERIVERS:
                    events.append(("derive", arg.id, node))
                elif last not in _RNG_NONCONSUMING:
                    events.append(("sink", arg.id, node))
            elif last in _RNG_DERIVERS:
                events.append(("derive", arg.id, node))
            elif last in sinks:
                events.append(("sink", arg.id, node))
        events.sort(key=lambda e: (e[2].lineno, e[2].col_offset))
        return events

    def _apply(self, stmt, state, res, sinks, findings, ctx, fn, severity):
        for kind, key, node in self._events(stmt, res, sinks):
            status = state.get(key)
            if kind == "sink":
                if status in ("derived", "sunk"):
                    how = ("already consumed by a sampler"
                           if status == "sunk"
                           else "already used to derive subkeys")
                    findings.append(Finding(
                        ctx.rel, node.lineno, node.col_offset, self.rule,
                        f"threefry key `{key}` {how}; pass a fresh "
                        "split/fold_in product instead of reusing it",
                        severity, func_line=_func_line(fn)))
                state[key] = "sunk"
            else:
                if status == "sunk":
                    findings.append(Finding(
                        ctx.rel, node.lineno, node.col_offset, self.rule,
                        f"threefry key `{key}` was consumed by a sampler "
                        "and is now re-derived; derive before sampling",
                        severity, func_line=_func_line(fn)))
                elif status != "sunk":
                    state[key] = "derived"
        # plain reassignment of a name resets its key state
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for tgt in targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        state.pop(n.id, None)

    def _merge(self, states):
        live = [s for s in states if s is not None]
        if not live:
            return None
        merged = {}
        for s in live:
            for k, v in s.items():
                if k not in merged or _RANK[v] > _RANK[merged[k]]:
                    merged[k] = v
        return merged

    def _scan_block(self, stmts, state, res, sinks, findings, ctx, fn,
                    severity):
        """Abstract interpretation of one statement list; returns the exit
        state or None when every path terminates (return/raise)."""
        args = (res, sinks, findings, ctx, fn, severity)
        for stmt in stmts:
            if isinstance(stmt, (ast.Return, ast.Raise)):
                self._apply(stmt, state, *args)
                return None
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                self._apply(ast.Expr(stmt.test), state, *args)
                s1 = self._scan_block(stmt.body, dict(state), *args)
                s2 = self._scan_block(stmt.orelse, dict(state), *args)
                merged = self._merge([s1, s2])
                if merged is None:
                    return None
                state.clear()
                state.update(merged)
            elif isinstance(stmt, (ast.For, ast.While)):
                head = stmt.iter if isinstance(stmt, ast.For) else stmt.test
                self._apply(ast.Expr(head), state, *args)
                if isinstance(stmt, ast.For):
                    for n in ast.walk(stmt.target):
                        if isinstance(n, ast.Name):
                            state.pop(n.id, None)
                # two passes: the second exposes cross-iteration key reuse
                s1 = self._scan_block(list(stmt.body), dict(state), *args)
                if s1 is not None:
                    s2 = self._scan_block(list(stmt.body), dict(s1), *args)
                    merged = self._merge([state, s1, s2])
                    state.clear()
                    state.update(merged)
                s3 = self._scan_block(stmt.orelse, dict(state), *args)
                if s3 is not None:
                    state.update(s3)
            elif isinstance(stmt, ast.Try):
                s1 = self._scan_block(stmt.body, dict(state), *args)
                hs = [self._scan_block(h.body, dict(state), *args)
                      for h in stmt.handlers]
                merged = self._merge([s1] + hs)
                if merged is None and not stmt.finalbody:
                    return None
                state.clear()
                state.update(merged or {})
                sf = self._scan_block(stmt.finalbody, state, *args)
                if sf is None:
                    return None
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._apply(ast.Expr(item.context_expr), state, *args)
                sb = self._scan_block(stmt.body, state, *args)
                if sb is None:
                    return None
            else:
                self._apply(stmt, state, *args)
        return state


# -- PSR104: dtype hygiene ---------------------------------------------------

class DtypeChecker:
    rule = "PSR104"

    def check(self, ctx):
        if not ctx.in_device_modules():
            return
        res = _resolver_of(ctx)
        severity = RULES[self.rule][0]
        exempt = _guarded_of(ctx)
        func_stack = []

        def visit(node, parents):
            is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            if is_fn:
                func_stack.append(node)
            if id(node) not in exempt:
                fn = func_stack[-1] if func_stack else None
                derived = _derived_of(ctx, fn) if fn is not None else set()
                yield from self._check_node(ctx, res, node, parents, derived,
                                            severity, _func_line(fn))
            for child in ast.iter_child_nodes(node):
                yield from visit(child, (node,) + parents[:1])
            if is_fn:
                func_stack.pop()

        yield from visit(ctx.tree, ())

    def _check_node(self, ctx, res, node, parents, derived, severity,
                    func_line):
        def finding(msg):
            return Finding(ctx.rel, node.lineno, node.col_offset, self.rule,
                           msg, severity, func_line=func_line)

        if isinstance(node, (ast.Attribute, ast.Name)):
            name = res.resolve(node)
            if name in _TORCH_F64:
                yield finding(
                    f"`{name}` in device code breaks float32 "
                    "bit-reproducibility (the card's float64 rate is a "
                    "fraction of float32's; keep f64 host-side or split "
                    "hi/lo — ops/dfloat.py)")
            return
        if not isinstance(node, ast.Call):
            return
        name = res.call_name(node) or ""
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "double" and not node.args
                and not name.startswith(("numpy.", "scipy."))):
            yield finding("`.double()` makes a float64 tensor in device "
                          "code; keep float32 (or split hi/lo)")
        if not name.startswith(("numpy.", "scipy.")):
            for kw in node.keywords:
                if kw.arg != "dtype":
                    continue
                if isinstance(kw.value, ast.Name) and kw.value.id == "float":
                    yield finding("`dtype=float` means float64; name the "
                                  "width explicitly (torch.float32)")
                elif (isinstance(kw.value, ast.Constant)
                      and kw.value.value == "float64"):
                    yield finding('`dtype="float64"` in device code breaks '
                                  "float32 bit-reproducibility")
        if name in _HOST_DATA_CONSTRUCTORS:
            if (not self._has_dtype(node, res) and node.args
                    and not self._literal(node.args[0])
                    and not self._typed_host(node.args[0], res)
                    and not _is_tensor(node.args[0], res, derived)
                    and not self._pinned(parents, res)):
                yield finding(
                    f"`{name}` of host data without dtype= keeps the "
                    "host array's dtype (a numpy float64 array lands on "
                    "the card as float64); pin dtype=")
        elif (name == "torch.from_numpy" and node.args
              and not self._typed_host(node.args[0], res)
              and not self._pinned(parents, res)):
            yield finding(
                "`torch.from_numpy` keeps the host array's dtype (float64 "
                "for a default numpy array); pin it with .float()/.long() "
                "or build the tensor with dtype=")

    @staticmethod
    def _literal(arg):
        """Python literals and displays of them (``3``, ``[n, 2]``) make
        int64, bool or default-dtype (float32) tensors, never float64."""
        if isinstance(arg, ast.Constant):
            return isinstance(arg.value, (bool, int, float))
        return isinstance(arg, (ast.List, ast.Tuple))

    @staticmethod
    def _typed_host(arg, res):
        """A numpy call that names its dtype (``np.asarray(x, np.float32)``,
        ``np.float32(x)``, ``np.cumsum(p, dtype=np.float32)``) hands over
        an array of that dtype."""
        if not isinstance(arg, ast.Call):
            return False
        name = res.call_name(arg) or ""
        if not name.startswith("numpy."):
            return False
        if name.split(".")[-1] in _DTYPE_TOKENS:
            return True
        return DtypeChecker._has_dtype(arg, res)

    @staticmethod
    def _has_dtype(call, res):
        if any(kw.arg == "dtype" for kw in call.keywords):
            return True
        return any(res.dtype_like(arg) for arg in call.args[1:])

    @staticmethod
    def _pinned(parents, res):
        """Whether the call is the receiver of a method that pins its
        dtype: ``.float()``, ``.long()``, ... or ``.to(<dtype>)``."""
        if not parents or not isinstance(parents[0], ast.Attribute):
            return False
        attr = parents[0].attr
        if attr in _DTYPE_METHODS:
            return True
        call = parents[1] if len(parents) > 1 else None
        return (attr == "to" and isinstance(call, ast.Call)
                and (any(kw.arg == "dtype" for kw in call.keywords)
                     or any(res.dtype_like(a) for a in call.args)))


# -- PSR105: global mutable state ---------------------------------------------

class GlobalStateChecker:
    rule = "PSR105"

    def check(self, ctx):
        severity = RULES[self.rule][0]
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            declared = set()
            for node in _walk_no_nested_defs(fn):
                if isinstance(node, ast.Global):
                    declared.update(node.names)
            if not declared:
                continue
            mutated = set()
            for node in _walk_no_nested_defs(fn):
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for tgt in targets:
                        if (isinstance(tgt, ast.Name)
                                and tgt.id in declared):
                            mutated.add(tgt.id)
            # `global X` + assignment IS module-global mutation whether or
            # not X also has a module-level initializer
            for name in sorted(mutated):
                yield Finding(
                    ctx.rel, fn.lineno, fn.col_offset, self.rule,
                    f"`{fn.name}` rebinds module-level `{name}`: "
                    "process-global state silently couples independent "
                    "instances (the simulate.py ephemeris bug class); "
                    "prefer instance state or explicit re-application",
                    severity, func_line=_func_line(fn))


# -- PSR106: mesh axis consistency ---------------------------------------------

class ShardingAxesChecker:
    rule = "PSR106"

    def check(self, ctx):
        if not ctx.mesh_axes:
            return
        res = _resolver_of(ctx)
        severity = RULES[self.rule][0]
        func_stack = []

        def visit(node):
            is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            if is_fn:
                func_stack.append(node.lineno)
            for el in self._axis_uses(res, node):
                if (isinstance(el, ast.Constant)
                        and isinstance(el.value, str)
                        and el.value not in ctx.mesh_axes):
                    yield Finding(
                        ctx.rel, el.lineno, el.col_offset, self.rule,
                        f"sharding axis '{el.value}' is not defined "
                        "by the mesh (known axes: "
                        f"{sorted(ctx.mesh_axes)}); the lookup would "
                        "fail at runtime or silently replicate",
                        severity,
                        func_line=func_stack[-1] if func_stack else 0)
            for child in ast.iter_child_nodes(node):
                yield from visit(child)
            if is_fn:
                func_stack.pop()

        yield from visit(ctx.tree)

    @staticmethod
    def _meshy(node):
        dotted = _dotted(node) or ""
        return "mesh" in dotted.split(".")[-1].lower()

    def _axis_uses(self, res, node):
        """The expressions ``node`` uses as mesh axis names: the arguments
        of a ``PartitionSpec``/``P`` call (the reference's idiom), the key
        of ``<mesh>.shape[...]`` and the left side of ``... in
        <mesh>.axis_names`` (the port's :class:`~psrsigsim_torch.parallel.
        Mesh` lookups).  ``Mesh(...)`` axis tuples are definitions."""
        if isinstance(node, ast.Call):
            name = res.call_name(node) or ""
            if name.split(".")[-1] == "PartitionSpec" or (
                    isinstance(node.func, ast.Name) and node.func.id == "P"):
                for arg in node.args:
                    yield from (arg.elts if isinstance(arg, ast.Tuple)
                                else [arg])
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Attribute)
              and node.value.attr == "shape"
              and self._meshy(node.value.value)):
            yield node.slice
        elif (isinstance(node, ast.Compare) and len(node.ops) == 1
              and isinstance(node.ops[0], (ast.In, ast.NotIn))
              and isinstance(node.comparators[0], ast.Attribute)
              and node.comparators[0].attr == "axis_names"):
            yield node.left


def default_checkers():
    return [
        TraceSafetyChecker(),
        HostNumpyChecker(),
        RngReuseChecker(),
        DtypeChecker(),
        GlobalStateChecker(),
        ShardingAxesChecker(),
    ]
