"""The port's event registry (``deepspeed_tpu_torch/telemetry/event_registry.py``)
against the JAX package's: the same entries and the same generated table,
and every event-name literal the port's sources emit is registered (the
JAX package's ``event-registry`` lint rule, applied to the port)."""

import ast
from pathlib import Path

from deepspeed_tpu.analysis.checkers.event_registry import _PREFIXES, EVENT_RE
from deepspeed_tpu.telemetry import event_registry as jreg
from deepspeed_tpu_torch.telemetry import event_registry as treg

PORT = Path(__file__).resolve().parents[1] / "deepspeed_tpu_torch"


def _event_names(path: Path):
    """(line, literal) of every event-name literal in ``path`` and (line,
    head) of every f-string name, as the lint rule finds them: string
    constants that match ``EVENT_RE`` outside statement position
    (docstrings), and f-strings whose literal head has a known prefix."""
    tree = ast.parse(path.read_text())
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    literals, heads = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if EVENT_RE.match(node.value) and not isinstance(parents.get(node), (ast.Expr, ast.JoinedStr)):
                literals.append((node.lineno, node.value))
        elif isinstance(node, ast.JoinedStr):
            head = node.values[0].value if node.values and isinstance(node.values[0], ast.Constant) else ""
            if not head.startswith(_PREFIXES):
                continue
            if all(isinstance(v, ast.Constant) for v in node.values):
                full = "".join(v.value for v in node.values)
                if EVENT_RE.match(full):
                    literals.append((node.lineno, full))
            else:
                heads.append((node.lineno, head))
    return literals, heads


def test_port_registry_equals_jax_registry():
    assert treg.EVENTS == jreg.EVENTS
    assert treg.DYNAMIC == jreg.DYNAMIC
    assert treg.render_event_table() == jreg.render_event_table()
    assert treg.registered_names() == jreg.registered_names()
    assert treg.dynamic_prefixes() == jreg.dynamic_prefixes()


def test_every_event_name_the_port_emits_is_registered():
    """Literals strictly against ``EVENTS``; f-string heads against the
    ``DYNAMIC`` prefix families.  The checkpoint path's four
    ``resilience/ckpt_*`` events are among the literals found."""
    names, prefixes = treg.registered_names(), treg.dynamic_prefixes()
    found, bad = set(), []
    for path in sorted(PORT.rglob("*.py")):
        if path.name == "event_registry.py":
            continue
        literals, heads = _event_names(path)
        rel = path.relative_to(PORT.parent)
        for line, name in literals:
            found.add(name)
            if name not in names:
                bad.append(f"{rel}:{line}: {name!r} is not registered")
        for line, head in heads:
            if not any(head.startswith(p) or p.startswith(head) for p in prefixes):
                bad.append(f"{rel}:{line}: f-string {head!r}... matches no DYNAMIC family")
    assert not bad, "\n".join(bad)
    assert {"resilience/ckpt_published", "resilience/ckpt_invalid_tag", "resilience/ckpt_fallback",
            "resilience/ckpt_retention_delete"} <= found


def test_unregistered_literal_is_found(tmp_path):
    """The walk sees a literal in a call and an f-string head, and skips a
    docstring."""
    src = tmp_path / "emitter.py"
    src.write_text('"""resilience/not_a_doc_event"""\n'
                   'def f(rid):\n'
                   '    emit("resilience/no_such_event")\n'
                   '    emit(f"nowhere/{rid}")\n'
                   '    emit(f"fleet/health/{rid}")\n')
    literals, heads = _event_names(src)
    assert literals == [(3, "resilience/no_such_event")]
    assert heads == [(5, "fleet/health/")]
    assert "resilience/no_such_event" not in treg.registered_names()


def test_port_injection_sites_equal_jax_sites():
    """The port's named fault-injection sites are the JAX package's, the
    offload tiers' ``host_opt.save``/``host_opt.load``/``swap.write``/
    ``swap.read`` among them."""
    from deepspeed_tpu.resilience import fault_injection as jfi
    from deepspeed_tpu_torch.resilience import fault_injection as tfi
    assert tfi.INJECTION_SITES == jfi.INJECTION_SITES
    assert {"host_opt.save", "host_opt.load", "swap.write", "swap.read"} <= tfi.INJECTION_SITES
