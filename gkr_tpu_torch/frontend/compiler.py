"""r1cs -> layered GKR circuit compiler.

Algorithmic mirror of the reference's frontend (rust/src/convert.rs):

  1. each R1CS constraint A.B - C = 0 becomes a binary expression tree of
     Add/Mult/Value nodes; the `count_mult` sign heuristic decides whether to
     negate (A, C) or C alone to minimize constant-multiplication gates
     (convert.rs:363-379, 466-622);
  2. constraint trees are sorted by height (stable) and pairwise-merged into
     at most WIDTH_LIMIT=20 independent subcircuits (convert.rs:154-185);
  3. each subcircuit is flattened level-by-level into layers of Add/Mult
     gates, deduplicating repeated Value leaves per level via a `used` map
     + a lazily-created zero node, structurally deduplicating repeated
     Add/Mult children, padding each level to 2^k gates, and turning the
     penultimate level into the pure value-injection layer
     (convert.rs:187-358);
  4. the witness is swept through the layers to produce every W_i value
     table, asserting output[0] == 0 (constraint satisfaction,
     convert.rs:787-849).

Divergences from the reference (deliberate, documented):
  * the reference's symbol-table CSE is dormant (its insertion call is
    commented out, convert.rs:576) — we mirror the *effective* behavior and
    omit it entirely;
  * the reference crashes on purely-linear constraints (empty A or B makes
    `merge_nodes(vec![])` recurse forever, convert.rs:619-622, since node_c
    is only populated in the quadratic branch); we compile the C-tree for
    them instead;
  * structural dedup of Add/Mult children uses a memoized signature instead
    of the reference's O(n^2) deep-equality scan — same first-match
    semantics, linear time.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..circuit import GateLayer, GKRCircuit, get_k
from ..field import P

DEPTH_LIMIT = 10   # convert.rs:10 (gates the dormant CSE; kept for parity)
WIDTH_LIMIT = 20   # convert.rs:11


# -------------------------------------------------------------- node algebra

_SIG_INTERN: dict[tuple, int] = {}


class Node:
    __slots__ = ("kind", "left", "right", "expr", "sig", "depth")

    def __init__(self, kind, left=None, right=None, expr=None):
        self.kind = kind            # 'add' | 'mult' | 'val'
        self.left = left
        self.right = right
        self.expr = expr            # ('value', int) | ('var', int)
        key = (kind, expr,
               left.sig if left is not None else -1,
               right.sig if right is not None else -1)
        sig = _SIG_INTERN.get(key)
        if sig is None:
            sig = len(_SIG_INTERN)
            _SIG_INTERN[key] = sig
        self.sig = sig
        self.depth = 1 + max(left.depth if left else 0,
                             right.depth if right else 0)


def value_node(v: int) -> Node:
    return Node("val", expr=("value", v % P))


def var_node(i: int) -> Node:
    return Node("val", expr=("var", i))


def zero_node() -> Node:
    return value_node(0)


def add_node(l: Node, r: Node) -> Node:
    return Node("add", l, r)


def mult_node(l: Node, r: Node) -> Node:
    return Node("mult", l, r)


def merge_nodes(nodes: list[Node]) -> Node:
    """Balanced pairwise Add-tree (convert.rs:108-138, incl. the odd-count
    recursion shape)."""
    if not nodes:
        raise ValueError("merge_nodes on empty list (linear constraint bug "
                         "in reference; callers must special-case)")
    if len(nodes) == 1:
        return nodes[0]
    new = []
    width = len(nodes) // 2
    for i in range(width):
        new.append(add_node(nodes[2 * i], nodes[2 * i + 1]))
    if len(nodes) % 2 == 1:
        return add_node(merge_nodes(new), nodes[-1])
    return merge_nodes(new)


# ------------------------------------------------- constraint -> node trees

def _count_mult(lc) -> tuple[int, int]:
    """(negated-form const-mults, plain-form const-mults), convert.rs:363-379."""
    a = b = 0
    for coeff, _ in lc:
        c = coeff % P
        if c == 1:
            b += 1
        elif c == P - 1:
            a += 1
        else:
            a += 1
            b += 1
    return a, b


def _term_nodes(lc, negate: bool) -> list[Node]:
    """One node per (coeff, var): plain form uses coeff==1 bare, negated form
    uses coeff==-1 bare; otherwise Mult(const, var) with the sign applied."""
    out = []
    for coeff, x in lc:
        c = coeff % P
        if negate:
            if c == P - 1:
                out.append(var_node(x))
            else:
                out.append(mult_node(value_node((P - c) % P), var_node(x)))
        else:
            if c == 1:
                out.append(var_node(x))
            else:
                out.append(mult_node(value_node(c), var_node(x)))
    return out


def convert_constraints_to_nodes(constraints) -> list[list[Node]]:
    """Constraint list -> one root node per constraint (convert.rs:360-632;
    the dormant symbol-table CSE is omitted — see module docstring)."""
    groups = []
    for (a, b, c) in constraints:
        cnt_a = _count_mult(a)
        cnt_b = _count_mult(b)
        cnt_c = _count_mult(c)
        neg = (cnt_a[0] + cnt_b[0] + cnt_c[1]) > (cnt_a[1] + cnt_b[1] + cnt_c[0])

        node_a = _term_nodes(a, negate=neg)
        node_b = _term_nodes(b, negate=False)
        # C is carried with the opposite sign of A.B:
        #   neg=False: root = (-A).B... no — root = A.B + (-C); neg flips A,C.
        node_c = _term_nodes(c, negate=not neg)

        if node_a and node_b:
            root = add_node(mult_node(merge_nodes(node_a),
                                      merge_nodes(node_b)),
                            merge_nodes(node_c))
            groups.append([root])
        else:
            # linear constraint: A.B term absent -> prove C-sum == 0
            # (reference bug workaround, see module docstring)
            if node_c:
                groups.append([merge_nodes(node_c)])
            else:
                groups.append([zero_node()])
    return groups


# -------------------------------------------------------------- layerization

@dataclass
class IRLayer:
    node_types: list            # 'add' | 'mult' per gate
    operand_index: list         # (left, right) per gate


def _layerize(one_circuit: list[Node]):
    """convert.rs:187-353 — level-by-level flattening of one subcircuit."""
    height = max(n.depth for n in one_circuit)
    assert height >= 1
    layers: list[IRLayer] = []
    inputs: list[Node] = []

    current = list(one_circuit)
    for d in range(height + 1):
        k = get_k(len(current))
        while len(current) < (1 << k):
            current.append(zero_node())

        if d == height:
            inputs = current
            break

        node_types = []
        operand_idx = []
        nxt: list[Node] = []
        sig_pos: dict[int, int] = {}   # first position of each structure
        used: dict[tuple, int] = {}    # Expression -> position (Value dedup)
        zero_index = None

        def push(node: Node) -> int:
            pos = len(nxt)
            nxt.append(node)
            if node.sig not in sig_pos:
                sig_pos[node.sig] = pos
            return pos

        def handle_value(node: Node):
            nonlocal zero_index
            e = node.expr
            if e in used:
                node_types.append("add")
                operand_idx.append((used[e], zero_index))
                return
            if zero_index is None:
                zero_index = push(zero_node())
            node_types.append("add")
            if e[0] == "value" and e[1] == 0:
                used[e] = zero_index
                operand_idx.append((zero_index, zero_index))
            else:
                used[e] = len(nxt)
                operand_idx.append((len(nxt), zero_index))
                push(node)

        last_value_level = (d == height - 1)
        for node in current:
            if node.kind == "val":
                handle_value(node)
            elif last_value_level:
                raise AssertionError(
                    "non-value node at the value-injection level")
            else:
                node_types.append(node.kind)
                lpos = sig_pos.get(node.left.sig)
                if lpos is None:
                    lpos = push(node.left)
                rpos = sig_pos.get(node.right.sig)
                if rpos is None:
                    rpos = push(node.right)
                operand_idx.append((lpos, rpos))

        layers.append(IRLayer(node_types, operand_idx))
        current = nxt

    return layers, inputs


def compile_nodes(groups: list[list[Node]], width_limit: int = WIDTH_LIMIT):
    """convert.rs:154-358 `compile`: width-merge then layerize.

    `width_limit` caps the number of independent subcircuits (reference
    default 20 = convert.rs:11).  Recursive aggregation passes 1: every
    extra subcircuit proof costs the NEXT round a full verifier gadget
    whose size scales with proof depth, so small subcircuits multiply the
    embedded-verifier cost ~(#subcircuits)x while saving almost nothing."""
    gs = sorted(groups, key=lambda g: max(n.depth for n in g))  # stable sort
    while len(gs) > width_limit:
        new = []
        for i in range(len(gs) // 2):
            new.append(gs[2 * i] + gs[2 * i + 1])
        if len(gs) % 2 == 1:
            new.append(gs[-1])
        gs = new
    total = []
    total_inputs = []
    for one in gs:
        layers, inputs = _layerize(one)
        total.append(layers)
        total_inputs.append(inputs)
    return total, total_inputs


# ---------------------------------------------------------- circuit assembly

def _ir_to_circuit(layers: list[IRLayer], input_len: int) -> GKRCircuit:
    input_k = get_k(input_len)
    gate_layers = []
    for i, layer in enumerate(layers):
        k_cur = get_k(len(layer.node_types))
        if i == len(layers) - 1:
            k_next = input_k
        else:
            k_next = get_k(len(layers[i + 1].node_types))
        add_gates = []
        mult_gates = []
        for gi, (t, (l, r)) in enumerate(zip(layer.node_types,
                                             layer.operand_index)):
            if t == "add":
                add_gates.append((gi, l, r))
            else:
                mult_gates.append((gi, l, r))
        gate_layers.append(GateLayer(k_cur, k_next, add_gates, mult_gates))
    return GKRCircuit(gate_layers, input_k)


def _input_values(input_nodes: list[Node], witness: list[int]) -> list[int]:
    vals = []
    for node in input_nodes:
        assert node.kind == "val", "input layer must be values"
        tag, v = node.expr
        vals.append(v % P if tag == "value" else witness[v] % P)
    return vals


def compile_r1cs_to_gkr(r1cs, wtns, sym_names: list[str] | None = None,
                        check: bool = True,
                        width_limit: int = WIDTH_LIMIT):
    """Full frontend (convert.rs:667-785 `convert_r1cs_wtns_gkr`):
    returns (circuits, w_values_list, public_outputs).

    `w_values_list[i]` is the dense forward sweep [W_0..W_input] for
    subcircuit i; `public_outputs` maps wire index -> (name, value) for the
    first n_pub_out + n_pub_in wires (convert.rs:652-665)."""
    if r1cs.header.prime != P:
        raise ValueError("r1cs prime is not BN254 Fr")
    witness = [v % P for v in wtns.values]

    groups = convert_constraints_to_nodes(r1cs.constraints)
    ir_list, input_list = compile_nodes(groups, width_limit=width_limit)

    circuits = []
    w_values_list = []
    for layers, input_nodes in zip(ir_list, input_list):
        circuit = _ir_to_circuit(layers, len(input_nodes))
        inputs = _input_values(input_nodes, witness)
        w = circuit.evaluate(inputs)
        if check:
            assert w[0][0] % P == 0, \
                "constraint not satisfied: output[0] != 0 (convert.rs:838)"
        circuits.append(circuit)
        w_values_list.append(w)

    n_public = r1cs.header.n_pub_out + r1cs.header.n_pub_in
    public = {}
    for i in range(n_public):
        name = sym_names[i] if sym_names and i < len(sym_names) else f"w{i+1}"
        public[i + 1] = (name, witness[i + 1])
    return circuits, w_values_list, public
