"""aggregated.circom generation — the tera-template equivalent of
rust/src/aggregator.rs:215-314 `modify_circom_file`.

The generated block declares per-instance proof input signals, instantiates
`VerifyGKR(meta_i)` from this package's verifier circuit
(gkr_tpu_torch/circuits/gkr_verifier.circom), and wires every signal, then is
spliced into the user's circuit: the include goes after the `pragma` line
and the block before the final closing brace of the main template, exactly
like the reference."""

from __future__ import annotations

import os
import re

VERIFIER_CIRCUIT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "circuits", "gkr_verifier.circom")
FS_VERIFIER_CIRCUIT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "circuits", "gkr_verifier_fs.circom")

_BLOCK = """
    var d{i} = {meta0};
    var largest_k{i} = {meta1};
    signal input sumcheckProof{i}[d{i} - 1][2 * largest_k{i}][{meta4}];
    signal input sumcheckr{i}[d{i} - 1][2 * largest_k{i}];
    signal input q{i}[d{i} - 1][{meta5}];
    signal input D{i}[{meta3}][{meta2} + 1];
    signal input z{i}[d{i}][largest_k{i}];
    signal input r{i}[d{i} - 1];
    signal input inputFunc{i}[{meta6}][{meta7} + 1];
    verifier[{i}] = {tpl};
    for (var a = 0; a < d{i} - 1; a++) {{
        for (var b = 0; b < 2 * {meta1}; b++) {{
            for (var c = 0; c < {meta4}; c++) {{
                verifier[{i}].sumcheckProof[a][b][c] <== sumcheckProof{i}[a][b][c];
            }}
        }}
    }}
    for (var a = 0; a < d{i} - 1; a++) {{
        for (var b = 0; b < 2 * {meta1}; b++) {{
            verifier[{i}].sumcheckr[a][b] <== sumcheckr{i}[a][b];
        }}
    }}
    for (var a = 0; a < d{i} - 1; a++) {{
        for (var b = 0; b < {meta5}; b++) {{
            verifier[{i}].q[a][b] <== q{i}[a][b];
        }}
    }}
    for (var a = 0; a < {meta3}; a++) {{
        for (var b = 0; b < {meta2} + 1; b++) {{
            verifier[{i}].D[a][b] <== D{i}[a][b];
        }}
    }}
    for (var a = 0; a < d{i}; a++) {{
        for (var b = 0; b < {meta1}; b++) {{
            verifier[{i}].z[a][b] <== z{i}[a][b];
        }}
    }}
    for (var a = 0; a < d{i} - 1; a++) {{
        verifier[{i}].r[a] <== r{i}[a];
    }}
    for (var a = 0; a < {meta6}; a++) {{
        for (var b = 0; b < {meta7} + 1; b++) {{
            verifier[{i}].inputFunc[a][b] <== inputFunc{i}[a][b];
        }}
    }}
"""


def _lit(x) -> str:
    """Nested-array circom literal: [[2, 3], [3]] etc."""
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_lit(v) for v in x) + "]"
    return str(x)


def render_verifier_block(metas: list[list[int]],
                          lens: list[tuple] | None = None) -> str:
    """The per-instance proof-signal + VerifyGKR instantiation block.

    With `lens` (per-instance (roundLens, qLens) from structural_lens),
    instantiates the Fiat-Shamir-strengthened VerifyGKRStrongFS
    (gkr_verifier_fs.circom) instead of the reference-parity-shaped
    VerifyGKR — the external signal layout is IDENTICAL, so the same
    aggregated.json drives either gadget."""
    parts = [f"\n    component verifier[{len(metas)}];\n"]
    for i, meta in enumerate(metas):
        if lens is None:
            inst = "[" + ", ".join(str(m) for m in meta) + "]"
            tpl = f"VerifyGKR({inst})"
        else:
            rl, ql = lens[i]
            tpl = (f"VerifyGKRStrongFS({_lit(meta)}, {_lit(rl)}, "
                   f"{_lit(ql)})")
        parts.append(_BLOCK.format(
            i=i, tpl=tpl,
            meta0=meta[0], meta1=meta[1], meta2=meta[2], meta3=meta[3],
            meta4=meta[4], meta5=meta[5], meta6=meta[6], meta7=meta[7]))
    return "".join(parts)


def structural_lens(proofs) -> list[tuple[list[list[int]], list[int]]]:
    """Per-instance (roundLens, qLens) template arguments for
    VerifyGKRStrongFS, extracted from the UNPADDED proofs (the structural
    lengths select the coefficient suffix each in-circuit MiMC hash
    consumes; gkr_verifier_fs.circom:98-114).  Rows are padded to the
    2*largest_k circom shape with zeros (those rows are never hashed)."""
    out = []
    for pr in proofs:
        largest_k = max(pr.k)
        rls = []
        for layer in pr.sumcheck_proofs:
            row = [len(rnd) for rnd in layer]
            row += [0] * (2 * largest_k - len(row))
            rls.append(row)
        out.append((rls, [len(qq) for qq in pr.q]))
    return out


_MAIN_RE = re.compile(
    r"component\s+main\s*(?:\{[^}]*\})?\s*=\s*(\w+)\s*\(")


def _main_template_close(lines: list[str]) -> int | None:
    """Line index of the closing brace of the template instantiated as
    `component main = Name(...)`, or None if it cannot be located.

    The reference inserts at the FIRST bare `}` line
    (aggregator.rs:298-306), which silently corrupts any user file whose
    main template is not the first one.  Locating the main template fixes
    multi-template files; single-template files (like the reference's
    t.circom) produce byte-identical output either way."""
    name = None
    for line in lines:
        m = _MAIN_RE.search(line)
        if m:
            name = m.group(1)
            break
    if name is None:
        return None
    tpl_re = re.compile(r"\btemplate\s+" + re.escape(name) + r"\s*\(")
    depth = 0
    inside = False
    for idx, line in enumerate(lines):
        if not inside:
            if tpl_re.search(line):
                inside = True
                depth = line.count("{") - line.count("}")
                if depth <= 0 and "{" in line:
                    return idx
        else:
            depth += line.count("{") - line.count("}")
            if depth <= 0:
                return idx
    return None


def modify_circom_file(path: str, metas: list[list[int]],
                       out_path: str = "aggregated.circom",
                       verifier_include: str | None = None,
                       lens: list[tuple] | None = None) -> str:
    """Splice the verifier block into the user's circom source
    (aggregator.rs:292-314 line-level semantics: include after the pragma,
    block before the closing brace of the MAIN template — located by
    instantiation, falling back to the reference's first-bare-`}` rule
    when no `component main = ...` can be parsed).

    `lens` (from structural_lens) switches the embedded gadget to the
    Fiat-Shamir-strengthened VerifyGKRStrongFS and the include to
    gkr_verifier_fs.circom — the CLI's --strong-circom mode."""
    include = verifier_include or (FS_VERIFIER_CIRCUIT if lens is not None
                                   else VERIFIER_CIRCUIT)
    with open(path) as f:
        content = f.read()

    block = render_verifier_block(metas, lens=lens)
    lines = content.splitlines()
    close_idx = _main_template_close(lines)
    out_lines = []
    added = False
    for idx, line in enumerate(lines):
        if line.startswith("pragma circom"):
            out_lines.append(line)
            out_lines.append(f'include "{include}";')
        elif not added and (idx == close_idx if close_idx is not None
                            else line.strip() == "}"):
            out_lines.append(block)
            out_lines.append(line if close_idx is not None else "}")
            added = True
        else:
            out_lines.append(line)
    with open(out_path, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    return out_path
