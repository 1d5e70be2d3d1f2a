"""Subprocess drivers for the external circom / node / snarkjs toolchain
(file_utils.rs:76-114 `execute_circom`, bin.rs:40-58 `mock-groth`).

All three tools are optional at runtime: environments without them (like
the GPU machines) can still run direct proving, host verification and
NATIVE recursion (recursion.native) — only the circom-compatible
aggregation path and the final groth16 hand-off need them."""

from __future__ import annotations

import os
import shutil
import subprocess


class ToolchainMissing(RuntimeError):
    pass


def _require(tool: str) -> str:
    path = shutil.which(tool)
    if path is None:
        raise ToolchainMissing(
            f"`{tool}` not found on PATH — the circom aggregation path needs "
            f"the external toolchain (circom/node/snarkjs); use native "
            f"recursion (--native) or install it")
    return path


def execute_circom(circuit_path: str, input_path: str,
                   workdir: str = ".") -> tuple[str, str]:
    """circom --r1cs --sym --wasm, then node generate_witness.js ->
    witness.wtns.  Returns (circuit_name, circuit_dir)."""
    _require("circom")
    _require("node")
    subprocess.run(["circom", circuit_path, "--r1cs", "--sym", "--wasm"],
                   cwd=workdir, check=True, capture_output=True)
    name = os.path.splitext(os.path.basename(circuit_path))[0]
    root = os.path.dirname(circuit_path)
    gen_js = os.path.join(workdir, f"{name}_js", "generate_witness.js")
    wasm = os.path.join(workdir, f"{name}_js", f"{name}.wasm")
    subprocess.run(["node", gen_js, wasm, input_path, "witness.wtns"],
                   cwd=workdir, check=True, capture_output=True)
    return name, (root + "/" if root else "")


def mock_groth(zkey: str, workdir: str = ".") -> None:
    """snarkjs zkey verify + groth16 prove (bin.rs:40-58)."""
    _require("snarkjs")
    out = subprocess.run(["snarkjs", "zkey", "verify", "aggregated.r1cs",
                          "pot.ptau", zkey],
                         cwd=workdir, check=True, capture_output=True)
    print(out.stdout.decode(), end="")
    out = subprocess.run(["snarkjs", "groth16", "prove", zkey,
                          "witness.wtns", "proof.json", "public.json"],
                         cwd=workdir, check=True, capture_output=True)
    print(out.stdout.decode(), end="")
    print("Aggregation is done.")


def toolchain_available() -> bool:
    return all(shutil.which(t) for t in ("circom", "node"))
