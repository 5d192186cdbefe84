"""Every public name of the JAX package has its counterpart in the port.

One case per module of ``mpc_iris_tpu/``: the module is read and walked with
``ast`` (never imported, so no JAX), and each public name it defines must
resolve by ``getattr`` in the port's counterpart module, inherited members
included. A public name is a top-level def or class without a leading
underscore, every name in ``__all__``, and every public method of a public
class. A JAX name whose counterpart is named differently, or that has none,
stands in ``RENAMED`` with its reason; a new public name in the JAX package
with neither fails here.
"""

import ast
import importlib
from pathlib import Path

import pytest

JAX_ROOT = Path(__file__).resolve().parent.parent / "mpc_iris_tpu"

# (JAX module path, JAX name) -> (port module, its name or None, why)
RENAMED = {
    ("ops/dot.py", "dot_bits_batch_i4"): (
        "mpc_iris_tpu_torch.ops.dot", "dot_bits_batch",
        "Hopper's tensor cores take int8, not int4: one int8 product serves both"),
    ("ops/dot.py", "kernel_self_test"): (
        "mpc_iris_tpu_torch.ops.self_test", "kernel_self_test",
        "the canary checks the kernel modules too, which import ops/dot.py"),
    ("ops/chacha.py", "share_planes_auto"): (
        "mpc_iris_tpu_torch.ops.chacha", "share_planes_kernel",
        "the wrapper dispatches on the tensor's device: the kernel on the card, "
        "the plain version on the CPU"),
    ("ops/chacha.py", "share_planes_natural_pallas"): (
        "mpc_iris_tpu_torch.ops.chacha", "share_planes_kernel",
        "the Pallas kernel's counterpart is the CUDA kernel csrc/chacha_planes.cu"),
    ("models/engines.py", "fractions_under_compact_packed_auto"): (
        "mpc_iris_tpu_torch.models.engines", "fractions_scan_packed_auto",
        "without jit the fused dispatch is two calls: fractions_scan_packed_auto "
        "(kernel (c) at B <= 8) then _compact_under_device"),
    ("utils/config.py", "enable_compile_cache"): (
        None, None,
        "the XLA compile cache has no torch counterpart; ops/_build.py caches "
        "the nvcc output by a hash of the sources"),
}


def port_module(rel: str) -> str:
    """The port's counterpart of a JAX module path: types/{bits,template,
    encoded}.py -> types.py, ops/select_pallas.py -> ops/select.py, any other
    module the same path."""
    parts = list(Path(rel).with_suffix("").parts)
    if parts[0] == "types":
        parts = ["types"]
    elif parts == ["ops", "select_pallas"]:
        parts = ["ops", "select"]
    elif parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["mpc_iris_tpu_torch", *parts])


def public_names(path: Path) -> set:
    """Top-level public defs and classes, ``__all__``, public methods of
    public classes (as ``Class.method``)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                          and not sub.name.startswith("_")}
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names |= set(ast.literal_eval(node.value))
    return names


def resolves(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_have_counterparts(rel):
    path = JAX_ROOT / rel
    target = port_module(rel)
    names = public_names(path)
    if rel == "__main__.py":
        # running it runs the CLI: compare the source, not the module
        port_src = (Path(__file__).resolve().parent.parent / "mpc_iris_tpu_torch"
                    / "__main__.py").read_text()
        assert "sys.exit(main())" in port_src and not names
        return
    module = importlib.import_module(target)
    missing = []
    for name in sorted(names):
        if (rel, name) in RENAMED:
            mod, new, why = RENAMED[(rel, name)]
            assert why
            if mod is not None:
                assert resolves(importlib.import_module(mod), new), (rel, name, mod, new)
            continue
        if not resolves(module, name):
            missing.append(name)
    assert not missing, f"{rel}: no counterpart in {target} for {missing}"


def test_renames_name_real_jax_functions():
    """Each RENAMED entry names a public function the JAX module still has."""
    for rel, name in RENAMED:
        assert name in public_names(JAX_ROOT / rel), (rel, name)


def test_every_jax_module_is_checked():
    assert len(MODULES) >= 40 and "ops/select_pallas.py" in MODULES
    assert {port_module(m) for m in ("types/bits.py", "types/template.py",
                                     "types/encoded.py")} == {"mpc_iris_tpu_torch.types"}
