"""Circuit introspection: parameter trees and net alias maps.

Reference equivalents: ``ParamObserver`` collects the full default parameter
hierarchy by running the circuit (reference/src/spectre.jl:205-248);
``aliasmap`` records subckt-port → parent-net aliasing via a Cassette
interpreter (reference/src/aliasextract.jl:3-40).  Here both are plain
walks of the elaborated graph — the hierarchy is explicit data.

Copy of ``cedarsim_tpu/utils/inspect.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations


def param_tree(circuit):
    """Nested dict of every instance's parameters, keyed by hierarchy:
    {"x1": {"r1": {"r": 1000.0}}, "v1": {"dc": 5.0}} — the ParamObserver
    view."""
    tree = {}
    for inst in circuit.instances:
        node = tree
        parts = inst.name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = {
            k: v for k, v in inst.params.items() if not k.endswith("$given")}
        if inst.mult != 1.0:
            node[parts[-1]]["m"] = inst.mult
    return tree


def flatten_param_list(tree, prefix=""):
    """{"x1.r1.r": 1000.0, ...} — the reference's flatten_param_list
    (reference/src/circuitodesystem.jl:101-145)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_param_list(v, key + "."))
        else:
            out[key] = v
    return out


def nest_param_list(flat):
    """Inverse of flatten_param_list: dotted names → nested dict."""
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def alias_map(circuit):
    """net name → canonical net name (subckt ports aliased to parent nets
    share a Net object; hierarchy-local names map to it)."""
    out = {}
    for name, net in circuit._nets.items():
        canon = "0" if net.is_ground else net.name
        if name != canon:
            out[name] = canon
    return out
