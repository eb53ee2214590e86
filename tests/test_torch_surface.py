"""The port's whole public surface against the JAX package's: every module,
public name, keyword and class member of ``sparsetpu`` has its counterpart
in ``sparsetpu_torch``, or stands in ``EXCEPTIONS`` with its reason.

The walk takes every module of ``sparsetpu`` (``pkgutil.walk_packages``;
``__main__`` and the native library skipped) and its public names:
``__all__``, or else the non-underscore names its source defines at top
level (functions, classes, assignments).  The port's module is the same
dotted path under ``sparsetpu_torch``, but for the two in ``MAPPED``.  For
each name:

  1. the name exists in the port's module, and is callable there where it
     is callable in the reference;
  2. each parameter of a reference callable (a function, a class's
     constructor, a public method) is a parameter of the port's, unless
     the port's takes ``**kwargs``; the reference's positional parameters
     keep their places, up to the first one the table excuses; and the
     port requires no parameter the reference does not have;
  3. each public method and property of a reference class exists on the
     port's class.

A name that a module re-exports from another (``__all__`` of a package)
is checked for 1 there, and for 2 and 3 where it is defined.

Every difference the walk finds must stand in ``EXCEPTIONS``, keyed
(module, name), (module, "name.member") or (module, "name(param)"), with
a reason of one of four categories (``CATEGORIES``); an entry that is no
longer a difference fails too.  The port's own names beyond the
reference's are listed in ``tests/test_torch_exports.py``.
"""

import ast
import importlib
import inspect
import linecache
import pkgutil
import textwrap
import types

import pytest

import sparsetpu

# reference module -> the port's modules that hold its names
MAPPED = {
    "kernels.spmv_pallas": ("kernels.spmv_gstream", "pack.final_levels"),
    "kernels.spmv_xla": ("kernels.spmv_coo",),
}

CATEGORIES = {
    "df64": "a (hi, lo) double-float helper: f64 is native FP64 on the "
            "card, a float64 tensor takes the place of the pair",
    "mesh": "JAX's mesh: the port runs one process a rank on "
            "torch.distributed, its process group in the mesh's place",
    "spmd": "an SPMD field of the JAX sharded class, which stacks every "
            "shard's tables for one program over the mesh: a rank here "
            "holds its own band (built from the band's device and its "
            "RowPartition), each band finishes over its own FinalRows, and "
            "no band is padded to one SPMD shape",
    "reimport": "a name the reference module only re-imports from another "
                "module; the port's counterpart stands where it is defined",
}

# the sharded classes' SPMD fields, each an entry of its own
_SPMD_FIELDS = {
    "ShardedSpmv": ("nr_rows", "row_starts", "rows_per_part", "values",
                    "meta16", "chunk_row", "step_window", "G",
                    "tiles_per_step", "n_steps", "padded_cols", "planes",
                    "interpret", "fin_meta", "fin_cell", "fin_route",
                    "fin_spill_pos", "fin_spill_row", "fin_static"),
    "RingShardedSpmv": ("nr_rows", "row_starts", "rows_per_part",
                        "stage_steps", "fin_meta", "fin_cell", "fin_route",
                        "fin_spill_pos", "fin_spill_row", "fin_static",
                        "interpret"),
    "ShardedSpmvDF64": ("nr_rows", "row_starts", "rows_per_part", "vhi",
                        "vlo", "meta16", "step_window", "cr_rows",
                        "cr_order", "G", "tiles_per_step", "n_steps",
                        "padded_cols", "interpret"),
}
# what the port's sharded classes are built from instead: the rank's band
# (its device, or its streams and map), the group and the RowPartition
_SPMD_PORT = {
    "ShardedSpmv": ("band", "group", "part"),
    "RingShardedSpmv": ("group", "part", "rows", "stage_off", "device"),
    "ShardedSpmvDF64": ("band", "group", "part", "nr_nzeros"),
}
_SPMD_HOME = {"ShardedSpmv": "dist.spmv_dist", "RingShardedSpmv": "dist.ring",
              "ShardedSpmvDF64": "dist.df64"}

EXCEPTIONS = {
    # -- df64 ------------------------------------------------------------
    ("", "DF64"): "df64",
    ("kernels.f64emu", "DF64"): "df64",
    ("kernels.f64emu", "df64_add"): "df64",
    ("kernels.f64emu", "df64_mul"): "df64",
    ("kernels.f64emu", "df64_dot"): "df64",
    ("kernels.f64emu", "df64_axpy"): "df64",
    ("kernels.f64emu", "spmv_df64_xla"): "df64",
    ("kernels.f64emu", "DF64GStreamDevice.finish_df64"): "df64",
    # -- mesh ------------------------------------------------------------
    ("dist.spmv_dist", "make_mesh(axis)"): "mesh",
    **{(mod, f"{fn}({p})"): "mesh"
       for mod, fn in (("dist.spmv_dist", "shard_spmv"),
                       ("dist.spmv_dist", "shard_spmv_auto"),
                       ("dist.ring", "ring_shard_spmv"),
                       ("dist.df64", "shard_spmv_df64"),
                       ("dist.multihost", "shard_spmv_multihost"))
       for p in ("mesh", "axis")},
    **{(_SPMD_HOME[cls], f"{cls}({p})"): "mesh"
       for cls in _SPMD_FIELDS for p in ("mesh", "axis")},
    # -- spmd ------------------------------------------------------------
    **{(_SPMD_HOME[cls], f"{cls}({p})"): "spmd"
       for cls, fields in _SPMD_FIELDS.items() for p in fields},
    **{(_SPMD_HOME[cls], f"{cls}(+{p})"): "spmd"
       for cls, fields in _SPMD_PORT.items() for p in fields},
    # -- reimport ----------------------------------------------------------
    # kernels/__init__.py re-imports the one-shot function from
    # spmv_pallas; the port's ``kernels.spmv_gstream`` is the module that
    # holds it (``kernels.spmv_gstream.spmv_gstream``)
    ("kernels", "spmv_gstream"): "reimport",
}


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

def public_names(mod):
    """``__all__``, or the non-underscore names the module's source defines
    at top level."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    names = []
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.append(node.target.id)
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _positional(sig):
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def compare_callable(name, ref, port, excused):
    """{item: what differs} for two callables' parameters."""
    out = {}
    rs, ps = _signature(ref), _signature(port)
    if rs is None:
        return out
    if ps is None:
        return {name: "the port's has no signature"}
    rp, pp = rs.parameters, ps.parameters
    varkw = any(p.kind == p.VAR_KEYWORD for p in pp.values())
    plain = [p for p in rp.values()
             if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    for p in plain:
        if p.name not in pp and not varkw:
            out[f"{name}({p.name})"] = "parameter missing"
    port_pos = _positional(ps)
    for i, p in enumerate(_positional(rs)):
        key = f"{name}({p})"
        if key in excused or key in out:
            break
        if i >= len(port_pos) or port_pos[i] != p:
            out[key] = f"positional parameter {i} is " + (
                repr(port_pos[i]) if i < len(port_pos) else "missing")
            break
    for p in pp.values():
        if p.default is p.empty and p.kind not in (
                p.VAR_POSITIONAL, p.VAR_KEYWORD) and p.name not in rp:
            out[f"{name}(+{p.name})"] = "the port requires it"
    return out


def _members(cls):
    """The public methods and properties a class defines or inherits."""
    out = {}
    for klass in reversed(cls.__mro__[:-1]):
        for k, v in vars(klass).items():
            if not k.startswith("_") and (inspect.isfunction(v) or isinstance(
                    v, (property, classmethod, staticmethod))):
                out[k] = v
    return out


def compare_module(rel, ref, ports, excused=frozenset()):
    """{(rel, item): what differs} between a reference module and the
    port's modules that hold its names."""
    out = {}
    for name in public_names(ref):
        a = getattr(ref, name)
        found = [getattr(p, name) for p in ports if hasattr(p, name)]
        if not found:
            out[(rel, name)] = "missing"
            continue
        b = found[0]
        if callable(a) and not callable(b):
            out[(rel, name)] = f"a {type(b).__name__} on the port"
            continue
        if getattr(a, "__module__", ref.__name__) != ref.__name__:
            continue            # a re-export: checked where it is defined
        if not callable(a):
            continue
        keyed = {k for (m, k) in excused if m == rel}
        diff = compare_callable(name, a, b, keyed)
        if isinstance(a, type):
            for mname, raw in _members(a).items():
                item = f"{name}.{mname}"
                if not hasattr(b, mname):
                    diff[item] = "member missing"
                elif not isinstance(raw, property):
                    diff.update(compare_callable(item, getattr(a, mname),
                                                 getattr(b, mname), keyed))
        out.update({(rel, k): v for k, v in diff.items()})
    return out


def reference_modules():
    """(rel, module) of every module of ``sparsetpu`` but ``__main__`` and
    the native library."""
    mods = [("", sparsetpu)]
    for info in pkgutil.walk_packages(sparsetpu.__path__, "sparsetpu."):
        if info.name.endswith("__main__") or \
                info.name.endswith("libsparsetpu_native"):
            continue
        mods.append((info.name[len("sparsetpu."):],
                     importlib.import_module(info.name)))
    return mods


def port_modules(rel):
    return [importlib.import_module("sparsetpu_torch" + ("." + r if r else ""))
            for r in MAPPED.get(rel, (rel,))]


def walk():
    out = {}
    for rel, mod in reference_modules():
        out.update(compare_module(rel, mod, port_modules(rel),
                                  frozenset(EXCEPTIONS)))
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def differences():
    return walk()


def test_every_module_has_its_counterpart():
    rels = [rel for rel, _ in reference_modules()]
    assert len(rels) > 40
    for rel in rels:
        assert port_modules(rel), rel


def test_every_difference_stands_in_the_table(differences):
    unlisted = {k: v for k, v in differences.items() if k not in EXCEPTIONS}
    assert not unlisted, "\n".join(f"{k}: {v}" for k, v in
                                   sorted(unlisted.items()))


def test_every_table_entry_is_a_difference(differences):
    stale = sorted(k for k in EXCEPTIONS if k not in differences)
    assert not stale, stale


def test_every_entry_has_a_reason_of_the_four_categories():
    assert set(EXCEPTIONS.values()) <= set(CATEGORIES)
    for cat in CATEGORIES:
        assert cat in EXCEPTIONS.values(), cat


def _module(name, source):
    """A module of ``source`` whose source ``inspect`` can read."""
    source = textwrap.dedent(source)
    path = f"<synthetic {name} {len(linecache.cache)}>"
    linecache.cache[path] = (len(source), None,
                             source.splitlines(True), path)
    mod = types.ModuleType(name)
    mod.__file__ = path
    exec(compile(source, path, "exec"), mod.__dict__)
    return mod


REF_SRC = """
    __all__ = ["Device", "run", "CONST"]
    CONST = 4

    class Device:
        def __init__(self, packed, interpret=False):
            self.packed = packed

        def spmv(self, x, x_is_packed=False):
            return x

        def spmv_f64(self, x):
            return x

        @property
        def shape(self):
            return (1, 1)

    def run(device, x_multi, repeats=20):
        return x_multi
"""


@pytest.mark.parametrize("case", [
    "same", "missing keyword", "missing member", "moved positional",
    "required extra", "missing name", "not callable"])
def test_walker_catches_a_synthetic_difference(case):
    """The walker on two small synthetic modules: a port that matches has
    no difference; each break of it shows as its own key."""
    port_src = REF_SRC
    want = set()
    if case == "missing keyword":
        port_src = port_src.replace("def run(device, x_multi, repeats=20)",
                                    "def run(device, X=None, repeats=20)")
        want = {"run(x_multi)"}
    elif case == "missing member":
        port_src = port_src.replace("def spmv_f64", "def _spmv_f64")
        want = {"Device.spmv_f64"}
    elif case == "moved positional":
        port_src = port_src.replace(
            "def __init__(self, packed, interpret=False)",
            "def __init__(self, packed, device='cuda', interpret=False)")
        want = {"Device(interpret)"}
    elif case == "required extra":
        port_src = port_src.replace("def run(device, x_multi, repeats=20)",
                                    "def run(device, x_multi, repeats=20, "
                                    "*, stream)")
        want = {"run(+stream)"}
    elif case == "missing name":
        port_src = port_src.replace("CONST = 4", "")
        want = {"CONST"}
    elif case == "not callable":
        port_src = port_src.replace("def run(", "def _run(") + \
            "    run = 3\n"
        want = {"run"}
    ref = _module("ref", REF_SRC)
    port = _module("ref", port_src)
    got = compare_module("m", ref, [port])
    assert {k for (_, k) in got} == want, got


def test_walker_stops_positions_at_an_excused_parameter():
    """A parameter the table excuses ends the positional check (the port's
    group stands where the mesh stood, and what follows moves up); a
    parameter the port lacks is a difference all the same."""
    ref = _module("ref", """
        def shard(matrix, mesh, axis="rows", config=None):
            return matrix
    """)
    forwards = _module("ref", """
        def shard(matrix, group=None, config=None, **kw):
            return matrix
    """)
    lacks = _module("ref", """
        def shard(matrix, group=None, config=None):
            return matrix
    """)
    excused = frozenset({("m", "shard(mesh)"), ("m", "shard(axis)")})
    assert compare_module("m", ref, [forwards]) == {
        ("m", "shard(mesh)"): "positional parameter 1 is 'group'"}
    assert compare_module("m", ref, [forwards], excused) == {}
    assert set(compare_module("m", ref, [lacks], excused)) == set(excused)
