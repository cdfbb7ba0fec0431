"""The port's public surface against the JAX package's, by name.

Both packages are read with ``ast`` (nothing is imported), module by
module: every public top-level function, class and constant of a
``rgbid_tpu/`` module, every public method and field of its classes and
every name its ``__init__.py`` re-exports must have a counterpart in the
same module of ``rgbid_tpu_torch/``; every parameter name of a shared
function or method must be a parameter of the port's, and a method must
be of the same kind (plain, static, class method, property). A name the
port imports from another of its modules counts, and its parameters are
those of the function it names.

What the port leaves out or names otherwise is listed in ``EXCEPTIONS``,
each entry with its reason and the words of README.md's paragraph "Kept
differences in names and parameters" that name it. An entry that no longer matches a difference
fails the test too, so the list stays as short as the differences.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "rgbid_tpu"
PORT_PKG = REPO / "rgbid_tpu_torch"

# (module, name, parameter or None) -> (reason, words of README.md that
# name the difference). ``name`` None stands for the whole module; a
# parameter "kind" for a method of another kind.
EXCEPTIONS = {
    ("ops/pallas_kernels.py", None, None): (
        "the four TPU Pallas kernels and their TPU tiling helpers (`_tile_rows`, "
        "`_pad_rows`); the port's hand CUDA kernels have their own wrappers in "
        "ops/kernels.py and mapping/fusion.py (PERF.md section 6)",
        "`ops/pallas_kernels.py`",
    ),
    ("ops/warp.py", "STACKED_GATHER", None): (
        "a TPU gather-layout switch with no meaning for the port's sampling",
        "`STACKED_GATHER`",
    ),
    ("ops/gauss_newton.py", "allreduce_irls", None): (
        "lives beside the IRLS kernels' result vectors in ops/kernels.py",
        "`allreduce_irls`",
    ),
    ("ops/gauss_newton.py", "esm_residuals_and_normal_eq", "stacked_gather"): (
        "TPU-only gather layout", "`stacked_gather`"),
    ("ops/gauss_newton.py", "residuals_and_normal_eq", "stacked_gather"): (
        "TPU-only gather layout", "`stacked_gather`"),
    ("ops/gauss_newton.py", "stratified_normal_eq", "stacked_gather"): (
        "TPU-only gather layout", "`stacked_gather`"),
    ("ops/gauss_newton.py", "stratified_normal_eq", "axis_name"): (
        "a shard_map axis; the port's row-sharded tracker all-reduces the sums itself",
        "`axis_name`"),
    ("ops/warp.py", "sample_tracker_planes", "stacked"): (
        "TPU-only gather layout", "`stacked`"),
    ("ops/warp.py", "sample_stack7", "stacked"): (
        "TPU-only gather layout", "`stacked`"),
    ("ops/gauss_newton.py", "esm_residuals_and_normal_eq", "cur_stack7"): (
        "renamed `cur_stack`: the stack holds 3 planes at L0 and 7 above", "`cur_stack`"),
    ("ops/warp.py", "sample_stack7", "stack7"): (
        "renamed `stack`: the stack holds 3 or 7 planes", "`stack7`"),
    ("ops/gauss_newton.py", "template_jacobians", "dtype"): (
        "renamed `jac_dtype`: a dtype name (string), not a JAX dtype", "`jac_dtype`"),
    ("mapping/manager.py", "KeyframeManager.finalize", "device_state"): (
        "renamed `source`: a keyframe state or a slot of the system's retire ring",
        "`source`"),
    ("tracking/step.py", "StepResult.pack", "kind"): (
        "a class method over the fields (the step packs tensors it has not wrapped "
        "in a StepResult), where the JAX package's is a method", "`StepResult.pack`"),
}

# Where a name the port keeps elsewhere lives: (module, name) -> port module.
MOVED = {("ops/gauss_newton.py", "allreduce_irls"): "ops/kernels.py"}

# The paragraph of README.md that names every entry of EXCEPTIONS.
README_BLOCK = "Kept differences in names and parameters"

_SELF = ("self", "cls")


def _params(fn: ast.FunctionDef, method: bool) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    if method and names and names[0] in _SELF:
        names = names[1:]
    return names


def _kind(fn: ast.FunctionDef) -> str:
    for d in fn.decorator_list:
        name = d.id if isinstance(d, ast.Name) else d.attr if isinstance(d, ast.Attribute) else ""
        if name in ("staticmethod", "classmethod"):
            return name
        if name in ("property", "cached_property", "setter"):
            return "property"
    return "method"


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))


class Module:
    """The names a module binds at its top level and in its classes:
    ``defs`` name -> parameters (functions and methods, "Class.method"),
    ``kinds`` "Class.method" -> kind, ``other`` classes, constants and
    fields, ``imports`` name -> (module path, name) for relative imports."""

    def __init__(self, root: Path, rel: str):
        self.root, self.rel = root, rel
        self.path = root / rel
        self.defs, self.kinds, self.other, self.imports = {}, {}, set(), {}
        if not self.path.exists():
            return
        for node in ast.parse(self.path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = _params(node, False)
            elif isinstance(node, ast.ClassDef):
                self.other.add(node.name)
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.defs[f"{node.name}.{b.name}"] = _params(b, True)
                        self.kinds[f"{node.name}.{b.name}"] = _kind(b)
                    elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                        self.other.add(f"{node.name}.{b.target.id}")
                    elif isinstance(b, ast.Assign):
                        self.other.update(f"{node.name}.{t.id}" for t in b.targets
                                          if isinstance(t, ast.Name))
            elif isinstance(node, ast.Assign):
                self.other.update(t.id for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                self.other.add(node.target.id)
            elif isinstance(node, ast.ImportFrom) and node.level > 0:
                base = Path(rel).parent
                for _ in range(node.level - 1):
                    base = base.parent
                for a in node.names:
                    target = base.joinpath(*node.module.split(".")) if node.module else base
                    self.imports[a.asname or a.name] = (target, a.name)

    @property
    def exists(self) -> bool:
        return self.path.exists()

    def names(self) -> set:
        return set(self.defs) | self.other | set(self.imports)

    def public_api(self) -> set:
        """Defined public names, and for a package's ``__init__.py`` the
        public names it re-exports."""
        own = {n for n in set(self.defs) | self.other if all(_public(p) for p in n.split("."))}
        # A module's own dunder functions (``__getattr__``) are import hooks.
        own -= {n for n in self.defs if n.startswith("__")}
        if self.path.name == "__init__.py":
            own |= {n for n in self.imports if _public(n)}
        return own

    def params(self, name: str, depth: int = 0):
        """Parameters of function ``name``, following the port's imports."""
        if name in self.defs:
            return self.defs[name]
        if name in self.imports and depth < 4:
            target, orig = self.imports[name]
            for rel in (f"{target}.py", f"{target}/__init__.py"):
                mod = Module(self.root, rel)
                if mod.exists and (orig in mod.defs or orig in mod.imports):
                    return mod.params(orig, depth + 1)
        return None


def _modules() -> list:
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def surface_differences() -> set:
    """Every difference, keyed as EXCEPTIONS is."""
    found = set()
    for rel in _modules():
        jax_mod, port_mod = Module(JAX_PKG, rel), Module(PORT_PKG, rel)
        if not port_mod.exists:
            found.add((rel, None, None))
            continue
        port_names = port_mod.names()
        for name in sorted(jax_mod.public_api()):
            if name not in port_names:
                found.add((rel, name, None))
                continue
            if name not in jax_mod.defs:
                continue
            theirs = port_mod.params(name)
            if theirs is None:
                found.add((rel, name, "kind"))
                continue
            found.update((rel, name, p) for p in jax_mod.defs[name] if p not in theirs)
            if name in jax_mod.kinds and jax_mod.kinds[name] != port_mod.kinds.get(name):
                found.add((rel, name, "kind"))
    return found


def test_every_jax_module_and_name_has_a_port_counterpart():
    unexplained = sorted(surface_differences() - set(EXCEPTIONS), key=str)
    assert not unexplained, (
        "names of rgbid_tpu missing from rgbid_tpu_torch, or parameters / method kinds that "
        f"differ, with no entry in EXCEPTIONS: {unexplained}")


def test_every_exception_is_a_live_difference():
    stale = sorted(set(EXCEPTIONS) - surface_differences(), key=str)
    assert not stale, f"EXCEPTIONS entries that no longer differ (remove them): {stale}"


@pytest.mark.parametrize("key", sorted(EXCEPTIONS, key=str), ids=lambda k: ":".join(
    str(p) for p in k if p is not None))
def test_exception_has_reason_and_readme_line(key):
    reason, words = EXCEPTIONS[key]
    assert len(reason) > 10
    readme = (REPO / "README.md").read_text()
    start = readme.index(README_BLOCK)
    kept = readme[start:readme.index("\n\n", start)]
    assert words in kept, f"README.md's {README_BLOCK!r} do not name {words}"


@pytest.mark.parametrize("key", sorted(MOVED), ids=lambda k: f"{k[0]}:{k[1]}")
def test_moved_names_live_in_their_port_module(key):
    rel, name = key
    assert name in Module(PORT_PKG, MOVED[key]).defs
    assert (rel, name, None) in EXCEPTIONS


def test_renamed_parameters_exist_under_their_port_names():
    renames = {"cur_stack7": "cur_stack", "stack7": "stack", "dtype": "jac_dtype",
               "device_state": "source"}
    for (rel, name, param) in EXCEPTIONS:
        if param in renames:
            assert renames[param] in Module(PORT_PKG, rel).params(name), (rel, name, param)


def test_the_walk_sees_a_removed_name(tmp_path):
    """A port module without one of the JAX package's functions is caught:
    the walk over a copy of ``core/se3.py`` with ``to_quaternion`` taken
    out reports it."""
    src = (PORT_PKG / "core" / "se3.py").read_text()
    start = src.index("def to_quaternion(")
    end = src.index("def from_quaternion(")
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "se3.py").write_text(src[:start] + src[end:])
    jax_mod, cut = Module(JAX_PKG, "core/se3.py"), Module(tmp_path, "core/se3.py")
    assert "to_quaternion" in jax_mod.public_api() - cut.names()
    assert not jax_mod.public_api() - Module(PORT_PKG, "core/se3.py").names()
