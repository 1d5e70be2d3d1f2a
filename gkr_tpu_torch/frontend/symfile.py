"""circom .sym file parsing (rust/src/convert.rs:851-871 `parse_sym`).

Lines have the form `#label,#wire,#component,fullname`; the reference takes
the first `num_public` lines and keeps the name segment after the first dot
(`main.foo` -> `foo`)."""

from __future__ import annotations


def parse_sym(path_or_text: str, num_public: int,
              is_text: bool = False) -> list[str]:
    if num_public == 0:
        return []
    if is_text:
        content = path_or_text
    else:
        with open(path_or_text) as f:
            content = f.read()
    res = []
    for line in content.splitlines():
        parts = line.split(",")
        if len(parts) < 4:
            continue
        name_main = parts[3].split(".")
        res.append(name_main[1] if len(name_main) > 1 else name_main[0])
        if len(res) == num_public:
            break
    return res


def write_sym(path: str, public_names: list[str]) -> None:
    """Emit the minimal circom-compatible .sym: one `#label,#wire,
    #component,fullname` line per public signal, wires 1..n in circom's
    public-first wire order (the subset parse_sym consumes — the reference
    reads only the first num_public lines, convert.rs:851-871)."""
    with open(path, "w") as f:
        for i, name in enumerate(public_names):
            f.write(f"{i + 1},{i + 1},0,main.{name}\n")
