"""Executable interpreter for the circom subset used by this package.

Without a circom compiler at hand, the committed circuit TEXT —
gkr_tpu_torch/circuits/gkr_verifier.circom, gkr_verifier_fs.circom, and
every generated aggregated.circom — would be trusted, never tested: a
syntax or wiring error would ship undetected.  This interpreter executes
the circuits against real witness data (aggregated.json) with the
semantics the circom compiler + wasm witness generator would apply, giving
the same catch-power as the reference's compile-and-witness integration
step (rust/src/aggregator.rs:437-458): a corrupted line fails the run
(tests/test_torch_circom_interp.py).  The port's copy of `gkr_tpu`'s
interpreter, line for line, on the port's `field` and `mimc`.

Supported subset (everything those files use):
  pragma / include; template decls with int- or array-valued parameters;
  signal input/output/internal decls with computed dims; var decls;
  component decls (scalar and array) + instantiation; for / if-else;
  ``<==`` / ``<--`` assignment, ``===`` constraint assertion, var
  assignment, ``++``/``--``/``+=``/``-=``; expressions with
  + - * ** % field-/ integer-\\ division, comparisons, && || !,
  array literals, member access (comp.sig), and ``component main
  {public [..]} = Tpl();``.

Execution model is circom's: a component's body runs when its LAST input
signal is assigned (templates with no inputs run at instantiation);
reading an unassigned signal or double-assigning one is an error.  All
arithmetic is over BN254 Fr (``/`` is field division: x * y^-1 mod p).

circomlib's MiMC7 (included by gkr_verifier_fs.circom and the example
circuit, exactly as the reference's rust/t.circom:2 includes it) is
provided as a BUILTIN with gkr_tpu_torch.mimc.Mimc7 semantics — circomlib
sources are not vendored; the builtin's equivalence to the iden3 circuit
is covered by the constant-chain tests in tests/test_mimc.py.
"""

from __future__ import annotations

import os
import re

from ..field import P


class CircomError(Exception):
    """Parse/semantic error in circuit text."""


class ConstraintFailure(CircomError):
    """A === constraint evaluated unequal (or an <== re-assignment)."""


# ------------------------------------------------------------- tokenizer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<lc>//[^\n]*)
  | (?P<bc>/\*.*?\*/)
  | (?P<num>\d+)
  | (?P<id>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<str>"[^"]*")
  | (?P<op><==|==>|<--|-->|===|\*\*|\+\+|--|\+=|-=|==|!=|<=|>=|&&|\|\|
       |[-+*/%\\<>!=(){}\[\],;.?:])
""", re.X | re.S)


def _tokenize(src: str, path: str):
    toks = []
    pos = 0
    line = 1
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise CircomError(f"{path}:{line}: unexpected character "
                              f"{src[pos]!r}")
        text = m.group(0)
        kind = m.lastgroup
        if kind not in ("ws", "lc", "bc"):
            toks.append((kind, text, line))
        line += text.count("\n")
        pos = m.end()
    toks.append(("eof", "", line))
    return toks


# ------------------------------------------------------------------ AST
# Statements and expressions are plain tuples; first element is the tag,
# last element of statements is the source line (for error messages).

class _Parser:
    def __init__(self, toks, path):
        self.toks = toks
        self.i = 0
        self.path = path

    def peek(self, ahead=0):
        return self.toks[self.i + ahead]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text):
        k, t, ln = self.next()
        if t != text:
            raise CircomError(f"{self.path}:{ln}: expected {text!r}, "
                              f"got {t!r}")
        return ln

    def at(self, text):
        return self.peek()[1] == text

    # ---- expressions (precedence climbing) ----

    def expr(self):
        return self._ternary()

    def _ternary(self):
        c = self._or()
        if self.at("?"):
            self.next()
            a = self.expr()
            self.expect(":")
            b = self._ternary()
            return ("cond", c, a, b)
        return c

    def _bin(self, sub, ops):
        e = sub()
        while self.peek()[1] in ops:
            op = self.next()[1]
            e = ("bin", op, e, sub())
        return e

    def _or(self):
        return self._bin(self._and, ("||",))

    def _and(self):
        return self._bin(self._eq, ("&&",))

    def _eq(self):
        return self._bin(self._rel, ("==", "!="))

    def _rel(self):
        return self._bin(self._add, ("<", "<=", ">", ">="))

    def _add(self):
        return self._bin(self._mul, ("+", "-"))

    def _mul(self):
        return self._bin(self._pow, ("*", "/", "\\", "%"))

    def _pow(self):
        e = self._unary()
        if self.at("**"):
            self.next()
            return ("bin", "**", e, self._pow())
        return e

    def _unary(self):
        if self.at("-"):
            ln = self.next()[2]
            return ("neg", self._unary(), ln)
        if self.at("!"):
            self.next()
            return ("not", self._unary())
        return self._postfix()

    def _postfix(self):
        e = self._atom()
        while True:
            if self.at("["):
                self.next()
                idx = self.expr()
                self.expect("]")
                e = ("index", e, idx)
            elif self.at("."):
                self.next()
                k, name, ln = self.next()
                if k != "id":
                    raise CircomError(f"{self.path}:{ln}: expected member")
                e = ("member", e, name)
            elif self.at("(") and e[0] == "name":
                # template call — valid only as an instantiation rhs
                self.next()
                args = []
                if not self.at(")"):
                    args.append(self.expr())
                    while self.at(","):
                        self.next()
                        args.append(self.expr())
                self.expect(")")
                e = ("call", e[1], args)
            else:
                return e

    def _atom(self):
        k, t, ln = self.next()
        if k == "num":
            return ("num", int(t))
        if k == "id":
            return ("name", t, ln)
        if t == "(":
            e = self.expr()
            self.expect(")")
            return e
        if t == "[":
            items = []
            if not self.at("]"):
                items.append(self.expr())
                while self.at(","):
                    self.next()
                    items.append(self.expr())
            self.expect("]")
            return ("array", items)
        raise CircomError(f"{self.path}:{ln}: unexpected token {t!r}")

    # ---- statements ----

    def _dims(self):
        dims = []
        while self.at("["):
            self.next()
            dims.append(self.expr())
            self.expect("]")
        return dims

    def block(self):
        ln = self.expect("{")
        stmts = []
        while not self.at("}"):
            stmts.append(self.stmt())
        self.expect("}")
        return ("block", stmts, ln)

    def _simple(self):
        """Assignment / constraint / inc-dec, WITHOUT the trailing ';'
        (shared by statements and for-init/step)."""
        k, t, ln = self.peek()
        if t == "var":
            self.next()
            _, name, _ = self.next()
            dims = self._dims()
            init = None
            if self.at("="):
                self.next()
                init = self.expr()
            return ("var", name, dims, init, ln)
        e = self.expr()
        op = self.peek()[1]
        if op in ("<==", "<--", "="):
            self.next()
            rhs = self.expr()
            return ("assign", op, e, rhs, ln)
        if op == "===":
            self.next()
            rhs = self.expr()
            return ("constraint", e, rhs, ln)
        if op in ("++", "--"):
            self.next()
            return ("incdec", op, e, ln)
        if op in ("+=", "-="):
            self.next()
            rhs = self.expr()
            return ("augassign", op, e, rhs, ln)
        return ("exprstmt", e, ln)

    def stmt(self):
        k, t, ln = self.peek()
        if t == "{":
            return self.block()
        if t == "signal":
            self.next()
            kind = "internal"
            if self.peek()[1] in ("input", "output"):
                kind = self.next()[1]
            _, name, _ = self.next()
            dims = self._dims()
            self.expect(";")
            return ("signal", kind, name, dims, ln)
        if t == "component":
            self.next()
            _, name, _ = self.next()
            dims = self._dims()
            if self.at("="):
                self.next()
                tpl, args = self._tpl_call()
                self.expect(";")
                return ("compinst", ("name", name, ln), tpl, args, ln)
            self.expect(";")
            return ("compdecl", name, dims, ln)
        if t == "for":
            self.next()
            self.expect("(")
            init = self._simple()
            self.expect(";")
            cond = self.expr()
            self.expect(";")
            step = self._simple()
            self.expect(")")
            body = self.stmt()
            return ("for", init, cond, step, body, ln)
        if t == "if":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            then = self.stmt()
            els = None
            if self.at("else"):
                self.next()
                els = self.stmt()
            return ("if", cond, then, els, ln)
        if t == "assert":
            self.next()
            self.expect("(")
            e = self.expr()
            self.expect(")")
            self.expect(";")
            return ("constraint", e, ("num", 1), ln)
        s = self._simple()
        self.expect(";")
        return s

    def _tpl_call(self):
        k, name, ln = self.next()
        if k != "id":
            raise CircomError(f"{self.path}:{ln}: expected template name")
        self.expect("(")
        args = []
        if not self.at(")"):
            args.append(self.expr())
            while self.at(","):
                self.next()
                args.append(self.expr())
        self.expect(")")
        return name, args

    # ---- top level ----

    def program(self):
        templates = {}
        includes = []
        main = None
        while self.peek()[0] != "eof":
            k, t, ln = self.peek()
            if t == "pragma":
                while self.next()[1] != ";":
                    pass
            elif t == "include":
                self.next()
                k2, s, _ = self.next()
                includes.append(s.strip('"'))
                self.expect(";")
            elif t == "template":
                self.next()
                _, name, _ = self.next()
                self.expect("(")
                params = []
                if not self.at(")"):
                    params.append(self.next()[1])
                    while self.at(","):
                        self.next()
                        params.append(self.next()[1])
                self.expect(")")
                body = self.block()
                templates[name] = Template(name, params, body)
            elif t == "component":
                # component main {public [a, b]} = Tpl(args);
                self.next()
                _, name, _ = self.next()
                if name != "main":
                    raise CircomError(f"{self.path}:{ln}: top-level "
                                      "component must be main")
                publics = []
                if self.at("{"):
                    self.next()
                    self.expect("public")
                    self.expect("[")
                    publics.append(self.next()[1])
                    while self.at(","):
                        self.next()
                        publics.append(self.next()[1])
                    self.expect("]")
                    self.expect("}")
                self.expect("=")
                tpl, args = self._tpl_call()
                self.expect(";")
                main = (tpl, args, publics)
            else:
                raise CircomError(f"{self.path}:{ln}: unexpected top-level "
                                  f"token {t!r}")
        return templates, includes, main


class Template:
    def __init__(self, name, params, body):
        self.name = name
        self.params = params
        self.body = body

    def __repr__(self):
        return f"Template({self.name})"


class BuiltinMiMC7(Template):
    """circomlib mimc.circom MiMC7(nrounds) — native stand-in (module
    docstring: circomlib sources are not vendored)."""

    def __init__(self):
        super().__init__("MiMC7", ["nrounds"], None)


# ---------------------------------------------------------------- runtime

def _make_storage(dims):
    if not dims:
        return [None]                      # scalar: 1-slot box
    if len(dims) == 1:
        return [None] * dims[0]
    return [_make_storage(dims[1:]) for _ in range(dims[0])]


def _count_slots(dims):
    n = 1
    for d in dims:
        n *= d
    return n


class _SignalDecl:
    __slots__ = ("kind", "dims", "store")

    def __init__(self, kind, dims):
        self.kind = kind
        self.dims = dims
        self.store = _make_storage(dims)


class Instance:
    def __init__(self, interp, tpl: Template, args, path="main"):
        self.interp = interp
        self.tpl = tpl
        self.path = path
        if len(args) != len(tpl.params):
            raise CircomError(f"{path}: {tpl.name} expects "
                              f"{len(tpl.params)} params, got {len(args)}")
        self.params = dict(zip(tpl.params, args))
        self.signals: dict[str, _SignalDecl] = {}
        self.components: dict[str, object] = {}
        self.executed = False
        self.total_inputs = 0
        self.assigned_inputs = 0
        if isinstance(tpl, BuiltinMiMC7):
            for nm in ("x_in", "k"):
                self.signals[nm] = _SignalDecl("input", [])
                self.total_inputs += 1
            self.signals["out"] = _SignalDecl("output", [])
        else:
            interp._interface_pass(self)
        if self.total_inputs == 0:
            self.interp._execute(self)

    # signal slot addressing -------------------------------------------

    def _slot(self, name, idx, ln):
        sig = self.signals.get(name)
        if sig is None:
            raise CircomError(f"{self.path}:{ln}: unknown signal {name}")
        if len(idx) != len(sig.dims):
            raise CircomError(f"{self.path}:{ln}: {name} expects "
                              f"{len(sig.dims)} indices, got {len(idx)}")
        store = sig.store
        if not sig.dims:
            return sig, store, 0
        for d, i in zip(sig.dims, idx):
            if not (0 <= i < d):
                raise CircomError(f"{self.path}:{ln}: index {i} out of "
                                  f"range {d} on {name}")
        for i in idx[:-1]:
            store = store[i]
        return sig, store, idx[-1] if idx else 0

    def read_signal(self, name, idx, ln):
        sig, store, last = self._slot(name, idx, ln)
        v = store[last]
        if v is None:
            raise CircomError(f"{self.path}:{ln}: read of unassigned "
                              f"signal {name}{idx}")
        return v

    def write_signal(self, name, idx, value, ln):
        sig, store, last = self._slot(name, idx, ln)
        if store[last] is not None:
            raise ConstraintFailure(f"{self.path}:{ln}: double assignment "
                                    f"of {name}{idx}")
        store[last] = value % P
        if sig.kind == "input":
            self.assigned_inputs += 1
            if (self.assigned_inputs == self.total_inputs
                    and not self.executed):
                self.interp._execute(self)


class Interpreter:
    """Load + run a circom file.  `include_dirs` resolves includes (the
    file's own directory is always searched first)."""

    def __init__(self, path: str, include_dirs: list[str] | None = None):
        self.templates: dict[str, Template] = {}
        self.include_dirs = list(include_dirs or [])
        self.main_decl = None
        self.constraints_checked = 0
        self._loaded: set[str] = set()
        self._load(path)
        if self.main_decl is None:
            raise CircomError(f"{path}: no `component main` declaration")

    # loading ----------------------------------------------------------

    def _load(self, path: str):
        real = os.path.realpath(path)
        if real in self._loaded:
            return
        self._loaded.add(real)
        with open(path) as f:
            src = f.read()
        templates, includes, main = _Parser(_tokenize(src, path),
                                            path).program()
        here = os.path.dirname(os.path.abspath(path))
        for inc in includes:
            if inc.replace("\\", "/").endswith("circomlib/circuits/mimc.circom"):
                self.templates.setdefault("MiMC7", BuiltinMiMC7())
                continue
            self._load(self._resolve(inc, here))
        for name, tpl in templates.items():
            if name in self.templates:
                raise CircomError(f"{path}: duplicate template {name}")
            self.templates[name] = tpl
        if main is not None:
            if self.main_decl is not None:
                raise CircomError(f"{path}: second main declaration")
            self.main_decl = main

    def _resolve(self, inc: str, here: str) -> str:
        for base in [here] + self.include_dirs:
            cand = os.path.join(base, inc)
            if os.path.exists(cand):
                return cand
        raise CircomError(f"include not found: {inc}")

    # running ----------------------------------------------------------

    def run_main(self, inputs: dict) -> dict:
        """Instantiate main, feed `inputs` (scalars or nested lists;
        decimal strings accepted), execute, return output signal values.
        Raises ConstraintFailure / CircomError on any violation."""
        tpl_name, arg_exprs, _publics = self.main_decl
        tpl = self.templates.get(tpl_name)
        if tpl is None:
            raise CircomError(f"main template {tpl_name} undefined")
        args = [self._eval_const(a) for a in arg_exprs]
        inst = Instance(self, tpl, args, path="main")
        for name, sig in inst.signals.items():
            if sig.kind != "input":
                continue
            if name not in inputs:
                raise CircomError(f"main input {name} missing from inputs")
            self._feed(inst, name, [], inputs[name], sig.dims)
        if not inst.executed:
            missing = [n for n, s in inst.signals.items()
                       if s.kind == "input"]
            raise CircomError(f"main inputs incomplete: {missing}")
        out = {}
        for name, sig in inst.signals.items():
            if sig.kind == "output":
                out[name] = self._read_tree(sig.store, sig.dims)
        return out

    def _feed(self, inst, name, idx, value, dims):
        if not dims:
            inst.write_signal(name, idx, int(value), 0)
            return
        if len(value) != dims[0]:
            raise CircomError(f"main input {name}: expected {dims[0]} "
                              f"entries, got {len(value)}")
        for i, v in enumerate(value):
            self._feed(inst, name, idx + [i], v, dims[1:])

    def _read_tree(self, store, dims):
        if not dims:
            return store[0]
        if len(dims) == 1:
            return list(store)
        return [self._read_tree(s, dims[1:]) for s in store]

    def _eval_const(self, ast):
        if ast[0] == "num":
            return ast[1]
        if ast[0] == "array":
            return [self._eval_const(a) for a in ast[1]]
        if ast[0] == "neg":
            return (-self._eval_const(ast[1])) % P
        raise CircomError("main template arguments must be literals")

    # template execution ----------------------------------------------

    def _interface_pass(self, inst: Instance):
        """Declare input/output signals (their dims may use top-level
        `var`s computed from params) without running compute statements."""
        env = dict(inst.params)
        for st in inst.tpl.body[1]:
            if st[0] == "var" and st[3] is not None and not st[2]:
                try:
                    env[st[1]] = self._eval(st[3], inst, env)
                except CircomError:
                    pass                      # value not needed for dims
            elif st[0] == "signal" and st[1] in ("input", "output"):
                _, kind, name, dim_exprs, ln = st
                dims = [self._as_int(self._eval(d, inst, env), ln)
                        for d in dim_exprs]
                if name in inst.signals:
                    raise CircomError(f"{inst.path}:{ln}: duplicate "
                                      f"signal {name}")
                sig = _SignalDecl(kind, dims)
                inst.signals[name] = sig
                if kind == "input":
                    inst.total_inputs += _count_slots(dims)

    def _execute(self, inst: Instance):
        inst.executed = True
        if isinstance(inst.tpl, BuiltinMiMC7):
            from ..mimc import Mimc7
            n = self._as_int(inst.params["nrounds"], 0)
            x = inst.read_signal("x_in", [], 0)
            k = inst.read_signal("k", [], 0)
            inst.write_signal("out", [], Mimc7(n).hash(x, k), 0)
            return
        env = dict(inst.params)
        self._exec_block(inst.tpl.body, inst, env)

    # statement evaluation ---------------------------------------------

    def _exec_block(self, block, inst, env):
        for st in block[1]:
            self._exec(st, inst, env)

    def _exec(self, st, inst, env):
        tag = st[0]
        if tag == "block":
            self._exec_block(st, inst, env)
        elif tag == "var":
            _, name, dim_exprs, init, ln = st
            if dim_exprs:
                dims = [self._as_int(self._eval(d, inst, env), ln)
                        for d in dim_exprs]
                env[name] = _make_storage(dims) if len(dims) > 1 \
                    else [0] * dims[0]
            else:
                env[name] = (self._eval(init, inst, env)
                             if init is not None else 0)
        elif tag == "signal":
            _, kind, name, dim_exprs, ln = st
            if kind in ("input", "output"):
                return                      # declared in the interface pass
            dims = [self._as_int(self._eval(d, inst, env), ln)
                    for d in dim_exprs]
            if name in inst.signals:
                raise CircomError(f"{inst.path}:{ln}: duplicate signal "
                                  f"{name}")
            inst.signals[name] = _SignalDecl(kind, dims)
        elif tag == "compdecl":
            _, name, dim_exprs, ln = st
            dims = [self._as_int(self._eval(d, inst, env), ln)
                    for d in dim_exprs]
            inst.components[name] = _make_storage(dims)
        elif tag == "compinst":
            _, target, tpl_name, arg_exprs, ln = st
            self._instantiate(target, tpl_name, arg_exprs, inst, env, ln)
        elif tag == "assign":
            _, op, lhs, rhs, ln = st
            # `name[..] = Tpl(args)` (component array slot) parses with a
            # call on the rhs — distinguish by rhs shape
            if (op == "=" and rhs[0] == "call"):
                self._instantiate(lhs, rhs[1], rhs[2], inst, env, ln)
                return
            val = self._eval(rhs, inst, env)
            self._assign(lhs, val, op, inst, env, ln)
        elif tag == "constraint":
            _, lhs, rhs, ln = st
            a = self._eval(lhs, inst, env)
            b = self._eval(rhs, inst, env)
            self.constraints_checked += 1
            if (a - b) % P != 0:
                raise ConstraintFailure(
                    f"{inst.path}:{ln}: constraint failed: {a} !== {b}")
        elif tag == "incdec":
            _, op, lhs, ln = st
            v = self._eval(lhs, inst, env)
            d = 1 if op == "++" else -1
            self._assign(lhs, (v + d) % P, "=", inst, env, ln)
        elif tag == "augassign":
            _, op, lhs, rhs, ln = st
            v = self._eval(lhs, inst, env)
            d = self._eval(rhs, inst, env)
            nv = (v + d) if op == "+=" else (v - d)
            self._assign(lhs, nv % P, "=", inst, env, ln)
        elif tag == "for":
            _, init, cond, step, body, ln = st
            self._exec(init, inst, env)
            guard = 0
            while self._truthy(self._eval(cond, inst, env)):
                self._exec(body, inst, env)
                self._exec(step, inst, env)
                guard += 1
                if guard > 10_000_000:
                    raise CircomError(f"{inst.path}:{ln}: runaway loop")
        elif tag == "if":
            _, cond, then, els, ln = st
            if self._truthy(self._eval(cond, inst, env)):
                self._exec(then, inst, env)
            elif els is not None:
                self._exec(els, inst, env)
        elif tag == "exprstmt":
            self._eval(st[1], inst, env)
        else:
            raise CircomError(f"unhandled statement {tag}")

    def _instantiate(self, target, tpl_name, arg_exprs, inst, env, ln):
        tpl = self.templates.get(tpl_name)
        if tpl is None:
            raise CircomError(f"{inst.path}:{ln}: unknown template "
                              f"{tpl_name}")
        args = [self._eval(a, inst, env) for a in arg_exprs]
        name, idx = self._lvalue_path(target, inst, env, ln)
        child = Instance(self, tpl, args,
                         path=f"{inst.path}.{name}"
                              + "".join(f"[{i}]" for i in idx))
        if name not in inst.components:
            if idx:
                raise CircomError(f"{inst.path}:{ln}: component array "
                                  f"{name} not declared")
            inst.components[name] = child
            return
        if not idx:
            inst.components[name] = child
            return
        store = inst.components[name]
        for i in idx[:-1]:
            store = store[i]
        store[idx[-1]] = child

    # lvalues ----------------------------------------------------------

    def _lvalue_path(self, ast, inst, env, ln):
        """name + index list for a `name[i][j]...` target."""
        idx = []
        while ast[0] == "index":
            idx.append(self._as_int(self._eval(ast[2], inst, env), ln))
            ast = ast[1]
        if ast[0] != "name":
            raise CircomError(f"{inst.path}:{ln}: unsupported lvalue")
        return ast[1], list(reversed(idx))

    def _assign(self, lhs, value, op, inst, env, ln):
        # component member: comp[..].sig[..] <== v
        base, member, midx = self._split_member(lhs)
        if member is not None:
            name, cidx = self._lvalue_path(base, inst, env, ln)
            child = self._component(inst, name, cidx, ln)
            mindices = [self._as_int(self._eval(i, inst, env), ln)
                        for i in midx]
            child.write_signal(member, mindices, value, ln)
            if op == "<==":
                self.constraints_checked += 1
            return
        name, idx = self._lvalue_path(lhs, inst, env, ln)
        if name in inst.signals:
            inst.write_signal(name, idx, value, ln)
            if op == "<==":
                self.constraints_checked += 1
            return
        if op in ("<==", "<--"):
            raise CircomError(f"{inst.path}:{ln}: {op} target {name} is "
                              "not a signal")
        if idx:
            store = env.get(name)
            if store is None:
                raise CircomError(f"{inst.path}:{ln}: unknown var {name}")
            for i in idx[:-1]:
                store = store[i]
            store[idx[-1]] = value
        else:
            env[name] = value

    def _split_member(self, ast):
        """a.b[i][j] -> (a-expr, "b", [i-expr, j-expr]); (expr, None, None)
        when no member access is present."""
        midx = []
        e = ast
        while e[0] == "index":
            midx.append(e[2])
            e = e[1]
        if e[0] == "member":
            return e[1], e[2], list(reversed(midx))
        return ast, None, None

    def _component(self, inst, name, idx, ln):
        c = inst.components.get(name)
        if c is None:
            raise CircomError(f"{inst.path}:{ln}: unknown component "
                              f"{name}")
        for i in idx:
            c = c[i]
        if not isinstance(c, Instance):
            raise CircomError(f"{inst.path}:{ln}: component {name}"
                              f"{idx} not instantiated")
        return c

    # expressions ------------------------------------------------------

    def _truthy(self, v):
        return (v % P) != 0 if isinstance(v, int) else bool(v)

    def _as_int(self, v, ln):
        if not isinstance(v, int):
            raise CircomError(f"line {ln}: expected integer, got {v!r}")
        return v

    def _eval(self, ast, inst, env):
        tag = ast[0]
        if tag == "num":
            return ast[1]
        if tag == "name":
            name = ast[1]
            if name in env:
                return env[name]
            if name in inst.signals:
                return inst.read_signal(name, [], ast[2])
            raise CircomError(f"{inst.path}:{ast[2]}: unknown name {name}")
        if tag == "array":
            return [self._eval(a, inst, env) for a in ast[1]]
        if tag == "neg":
            return (-self._as_num(self._eval(ast[1], inst, env))) % P
        if tag == "not":
            return 0 if self._truthy(self._eval(ast[1], inst, env)) else 1
        if tag == "cond":
            c = self._eval(ast[1], inst, env)
            return self._eval(ast[2] if self._truthy(c) else ast[3],
                              inst, env)
        if tag == "bin":
            op = ast[1]
            a = self._eval(ast[2], inst, env)
            if op == "&&":
                return (self._eval(ast[3], inst, env)
                        if self._truthy(a) else 0)
            if op == "||":
                return (a if self._truthy(a)
                        else self._eval(ast[3], inst, env))
            b = self._eval(ast[3], inst, env)
            return self._binop(op, a, b)
        if tag in ("index", "member"):
            # route the WHOLE chain through _eval_ref so multi-dim signal
            # reads collect every index (proofs[j][t], comp[i].sig[a][b])
            return self._eval_ref(ast, inst, env)
        if tag == "call":
            raise CircomError(f"template call {ast[1]} used as a value "
                              "(calls are only valid as component "
                              "instantiations)")
        raise CircomError(f"unhandled expression {tag}")

    def _as_num(self, v):
        if isinstance(v, int):
            return v
        raise CircomError(f"expected scalar, got {type(v).__name__}")

    def _binop(self, op, a, b):
        a = self._as_num(a)
        b = self._as_num(b)
        if op == "+":
            return (a + b) % P
        if op == "-":
            return (a - b) % P
        if op == "*":
            return (a * b) % P
        if op == "**":
            return pow(a, b, P)
        if op == "/":
            if b % P == 0:
                raise CircomError("field division by zero")
            return a * pow(b, P - 2, P) % P
        if op == "\\":
            return a // b
        if op == "%":
            return a % b
        if op == "==":
            return 1 if (a - b) % P == 0 else 0
        if op == "!=":
            return 0 if (a - b) % P == 0 else 1
        # comparisons on canonical representatives (loop bounds / indices)
        if op == "<":
            return 1 if a % P < b % P else 0
        if op == "<=":
            return 1 if a % P <= b % P else 0
        if op == ">":
            return 1 if a % P > b % P else 0
        if op == ">=":
            return 1 if a % P >= b % P else 0
        raise CircomError(f"unhandled operator {op}")

    def _index(self, base, i, inst, env):
        if isinstance(base, list):
            if not (0 <= i < len(base)):
                raise CircomError(f"index {i} out of range {len(base)}")
            return base[i]
        raise CircomError(f"cannot index into {type(base).__name__}")

    def _eval_ref(self, ast, inst, env):
        """Evaluate expressions that may address signals/components with
        index chains: name, name[i].., comp.member, comp[i].member[j]..."""
        # collect trailing indices
        idx_exprs = []
        e = ast
        while e[0] == "index":
            idx_exprs.append(e[2])
            e = e[1]
        idx_exprs.reverse()
        if e[0] == "member":
            base_expr, member = e[1], e[2]
            name, cidx = self._lvalue_path(base_expr, inst, env, 0)
            child = self._component(inst, name, cidx, 0)
            indices = [self._as_int(self._eval(i, inst, env), 0)
                       for i in idx_exprs]
            return child.read_signal(member, indices, 0)
        if e[0] == "name":
            name = e[1]
            indices = [self._as_int(self._eval(i, inst, env), 0)
                       for i in idx_exprs]
            if name in inst.signals:
                return inst.read_signal(name, indices, e[2])
            if name in env:
                v = env[name]
                for i in indices:
                    v = self._index(v, i, inst, env)
                return v
            raise CircomError(f"{inst.path}:{e[2]}: unknown name {name}")
        v = self._eval(e, inst, env)
        for iex in idx_exprs:
            v = self._index(v, self._as_num(self._eval(iex, inst, env)),
                            inst, env)
        return v


def run_circuit(path: str, inputs: dict,
                include_dirs: list[str] | None = None):
    """Parse + execute a circom file with `inputs` (aggregated.json-style:
    decimal strings or ints, nested lists).  Returns (outputs dict,
    constraints_checked).  Raises ConstraintFailure on any violated
    constraint — the executable stand-in for the reference's
    compile-and-witness step (aggregator.rs:437-458)."""
    interp = Interpreter(path, include_dirs=include_dirs)
    out = interp.run_main(inputs)
    return out, interp.constraints_checked
