"""The reference's control-plane tests, run on the port and held against
the reference run by run.

``mirror(name)`` turns the reference test module ``tests/<name>.py``
into tests of the port: its source is retargeted (``repro.`` becomes
``repro_torch.``, the ``"jit"`` backend becomes ``"torch"``) and each
test then runs twice, once as it stands on the reference package and
once retargeted on the port, each on its own fixtures and on the same
table bytes (the port's ``datagen`` loads go through the reference's
``datagen`` and ``storage_service.copy_objects``). Both runs record what
the engine answered: every ``QueryResult`` (or the structured failure it
raised), every ``ServeReport``, every ``explain`` text and every plan
``optimizer.lower`` made with its applied rules. The port must
pass the reference's own assertions, and the two records must be equal:

- results: keys, dtypes, counts and integers exactly, floats within
  rtol 1e-6;
- modeled runtimes, worker seconds and costs, stage metrics, request
  stats, ``adaptive_trace``, ``failure`` and the plan-cache fields
  exactly;
- every ``ServeReport`` field, each served query's and the admission
  dicts exactly;
- the ``explain`` text, where only ``backend=jit``/``backend=torch`` may
  differ;
- each lowered plan's JSON and its optimizer trace exactly.

Both runs read one pinned bench profile: the reference's own
``BENCH_engine.json`` with ``pipeline.torch_s`` set to its ``jit_s``, so
the planner models the two backends alike. The port runs on the CPU:
the mirror resolves every device the port asks for to the CPU. Each run
starts with its package's compiled-plan cache empty. Tests that use the
engine's default backend run on ``jit``/``torch`` and, where they do not
depend on the compiled backend, again on ``numpy``/``numpy``.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import itertools
import json
import pathlib
import re
import types

import numpy as np
import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent

_PORT_PREFIX = "repro_torch"


# Test oracles a reference test module imports that the port does not
# carry: the retargeted module takes the reference's own.
_ORACLES = {"segment_reduce_np": "repro.kernels.segment_reduce"}


def port_source(src: str) -> str:
    """A reference test module's source, retargeted at the port."""
    for name in _ORACLES:
        src = re.sub(rf"^(from repro\.\S+ import .+),\s*{name}\b", r"\1",
                     src, flags=re.M)
    src = re.sub(r"\brepro\.(?=[a-z_])", _PORT_PREFIX + ".", src)
    return src.replace('"jit"', '"torch"')


class _CopiedDatagen:
    """The port's ``datagen`` with its table loaders replaced: each table
    is generated by the reference's ``datagen`` into a fresh reference
    store and copied byte for byte into the port's store."""

    def __init__(self):
        from repro_torch.engine import datagen
        self._port = datagen

    def __getattr__(self, name):
        return getattr(self._port, name)

    @staticmethod
    def _copied(loader, store, *args, **kwargs):
        from repro.core.storage_service import ObjectStore as RefStore
        from repro_torch.core.storage_service import copy_objects
        src = RefStore()
        keys = loader(src, *args, **kwargs)
        copy_objects(src, store, prefix="")
        return keys

    def load_table(self, store, *args, **kwargs):
        from repro.engine import datagen
        return self._copied(datagen.load_table, store, *args, **kwargs)

    def load_table_hash_partitioned(self, store, *args, **kwargs):
        from repro.engine import datagen
        return self._copied(datagen.load_table_hash_partitioned, store,
                            *args, **kwargs)


@functools.lru_cache(maxsize=None)
def port_module(name: str) -> types.ModuleType:
    """``tests/<name>.py`` retargeted at the port, as a module."""
    path = TESTS / f"{name}.py"
    mod = types.ModuleType(f"port_of_{name}")
    mod.__file__ = str(path)
    src = path.read_text()
    exec(compile(port_source(src), str(path), "exec"), mod.__dict__)
    for name, ref in _ORACLES.items():
        if re.search(rf"\b{name}\b", src):
            setattr(mod, name,
                    getattr(importlib.import_module(ref), name))
    if "datagen" in mod.__dict__:
        mod.datagen = _CopiedDatagen()
    # Helper modules of the tests that build the engine's objects are
    # retargeted too.
    for helper in _HELPERS:
        if helper in mod.__dict__:
            setattr(mod, helper, port_module(helper))
    return mod


_HELPERS = ("golden_plans",)


# ---------------------------------------------------------------------------
# What a run answered
# ---------------------------------------------------------------------------

class _Recorder:
    """Patches one package's engine entry points to record what they
    return (outermost calls only) into ``log``."""

    def __init__(self, pkg: str, mp: pytest.MonkeyPatch):
        self.log: list = []
        self._depth = 0
        coord = importlib.import_module(f"{pkg}.engine.coordinator")
        adaptive = importlib.import_module(f"{pkg}.engine.adaptive")
        server = importlib.import_module(f"{pkg}.serve.query_server")
        explain = importlib.import_module(f"{pkg}.engine.explain")
        for cls in (coord.Coordinator, adaptive.AdaptiveCoordinator):
            mp.setattr(cls, "execute", self._wrap(cls.execute, "query"))
        mp.setattr(server.QueryServer, "serve",
                   self._wrap(server.QueryServer.serve, "serve"))
        for fn in ("explain", "format_adaptive"):
            mp.setattr(explain, fn, self._wrap(getattr(explain, fn), fn))
        optimizer = importlib.import_module(f"{pkg}.engine.optimizer")
        mp.setattr(optimizer, "lower", self._wrap(optimizer.lower, "lower"))

    def _wrap(self, fn, kind):
        rec = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rec._depth += 1
            try:
                out = fn(*args, **kwargs)
            except Exception as exc:
                if rec._depth == 1:
                    rec.log.append((kind + "_raised", exc))
                raise
            finally:
                rec._depth -= 1
            if rec._depth == 0:
                rec.log.append((kind, out))
            return out
        return wrapped


RTOL = 1e-6


def _canonical(batch) -> dict:
    cols = list(batch.keys())
    arrays = {c: np.asarray(batch[c]) for c in cols}
    keys = [arrays[c] for c in cols if arrays[c].dtype.kind in "iub"]
    if keys and len(arrays[cols[0]]):
        order = np.lexsort(keys[::-1])
        arrays = {c: a[order] for c, a in arrays.items()}
    return arrays


def assert_batches_equal(ref, got, where="result") -> None:
    a, b = _canonical(ref), _canonical(got)
    assert list(a) == list(b), f"{where}: columns {list(a)} != {list(b)}"
    for c in a:
        assert a[c].dtype == b[c].dtype, f"{where}.{c}: dtype"
        assert a[c].shape == b[c].shape, f"{where}.{c}: rows"
        if a[c].dtype.kind == "f":
            np.testing.assert_allclose(b[c], a[c], rtol=RTOL,
                                       err_msg=f"{where}.{c}")
        else:
            np.testing.assert_array_equal(b[c], a[c],
                                          err_msg=f"{where}.{c}")


def assert_query_results_equal(ref, got, where="query") -> None:
    """Every field of two ``QueryResult``s: the result batch within the
    float tolerance, every other field exactly."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "result":
            assert_batches_equal(a, b, f"{where}.result")
        elif dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), \
                f"{where}.{f.name}: {a} != {b}"
        else:
            assert a == b, f"{where}.{f.name}: {a!r} != {b!r}"


def assert_serve_reports_equal(ref, got, where="serve") -> None:
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name != "queries":
            assert a == b, f"{where}.{f.name}: {a!r} != {b!r}"
    assert ref.plan_cache_hit_rate == got.plan_cache_hit_rate
    assert len(ref.queries) == len(got.queries)
    for i, (a, b) in enumerate(zip(ref.queries, got.queries)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "result":
                assert_query_results_equal(x, y, f"{where}.queries[{i}]")
            elif f.name == "request":
                assert (x.tenant, x.submit_t) == (y.tenant, y.submit_t)
            else:
                assert x == y, f"{where}.queries[{i}].{f.name}: " \
                    f"{x!r} != {y!r}"


def explain_as_port(text: str) -> str:
    """A reference ``explain`` text with its backend named as the port
    names it."""
    return text.replace("(backend=jit)", "(backend=torch)")


def assert_records_equal(ref_log: list, port_log: list) -> None:
    kinds = [k for k, _ in ref_log]
    assert [k for k, _ in port_log] == kinds, \
        f"the runs answered differently: {kinds} vs " \
        f"{[k for k, _ in port_log]}"
    for i, ((kind, a), (_, b)) in enumerate(zip(ref_log, port_log)):
        where = f"{kind}[{i}]"
        if kind == "query":
            assert_query_results_equal(a, b, where)
        elif kind == "serve":
            assert_serve_reports_equal(a, b, where)
        elif kind in ("explain", "format_adaptive"):
            assert b == explain_as_port(a), where
        elif kind == "lower":
            (plan_a, report_a), (plan_b, report_b) = a, b
            assert plan_b.to_json() == plan_a.to_json(), where
            assert report_b.rules == report_a.rules, where
        else:       # a raised exception
            assert type(b).__name__ == type(a).__name__, where
            assert explain_as_port(str(b)) == explain_as_port(str(a)), \
                where
            assert getattr(b, "failure", None) == \
                getattr(a, "failure", None), where


# ---------------------------------------------------------------------------
# The environment both runs share
# ---------------------------------------------------------------------------

def pinned_profile_path(tmp_dir: pathlib.Path) -> pathlib.Path:
    """The reference's profile, with the port's ``torch`` rate set to the
    reference's ``jit`` rate."""
    data = json.loads((REPO / "BENCH_engine.json").read_text())
    data["pipeline"]["torch_s"] = data["pipeline"]["jit_s"]
    path = tmp_dir / "BENCH_pinned.json"
    path.write_text(json.dumps(data))
    return path


def _clear_caches() -> None:
    """Both packages' bench profiles and compiled-plan caches: each is
    one global of its process, which other tests fill."""
    from repro.core import bench_profile as rb
    from repro.engine import compile as rcompile
    from repro_torch.core import bench_profile as tb
    from repro_torch.engine import compile as tcompile
    rb.clear_cache()
    tb.clear_cache()
    rcompile.PLAN_CACHE.clear()
    tcompile.PLAN_CACHE.clear()


@pytest.fixture
def mirror_env(tmp_path, monkeypatch):
    """The pinned profile, empty plan caches, and every device of the
    port on the CPU."""
    from repro_torch.engine import compile as tcompile
    monkeypatch.setenv("REPRO_BENCH_PROFILE",
                       str(pinned_profile_path(tmp_path)))
    monkeypatch.setattr(tcompile, "resolve_device",
                        lambda device: torch.device("cpu"))
    _clear_caches()
    yield
    _clear_caches()


def _with_default_backend(pkg: str, backend: str, mp: pytest.MonkeyPatch):
    """Make ``backend`` the default of the package's coordinator and
    query server (an explicit backend still wins)."""
    import importlib
    coord = importlib.import_module(f"{pkg}.engine.coordinator")
    server = importlib.import_module(f"{pkg}.serve.query_server")
    for cls in (coord.Coordinator, server.QueryServer):
        sig = inspect.signature(cls.__init__)
        pos = list(sig.parameters).index("backend")
        orig = cls.__init__

        def init(self, *args, __orig=orig, __pos=pos, **kwargs):
            if len(args) < __pos:
                kwargs.setdefault("backend", backend)
            __orig(self, *args, **kwargs)
        mp.setattr(cls, "__init__", init)


# ---------------------------------------------------------------------------
# The mirror
# ---------------------------------------------------------------------------

def _id(value) -> str:
    """A case id that is the same in every process: a function by its
    name, not by its address."""
    return getattr(value, "__name__", None) or str(value)


def _param_cases(ref_fn, port_fn) -> list[tuple[str, dict, dict]]:
    """The reference test's parametrisations beside the port's (the same
    cases, with ``"jit"`` retargeted): ``(id, ref_kwargs, port_kwargs)``."""
    def marks(fn):
        return [m for m in getattr(fn, "pytestmark", [])
                if m.name == "parametrize"]
    rm, pm = marks(ref_fn), marks(port_fn)
    if not rm:
        return [("", {}, {})]
    axes = []
    for r, p in zip(rm, pm):
        names = [n.strip() for n in r.args[0].split(",")]
        axes.append([(names, rv, pv)
                     for rv, pv in zip(r.args[1], p.args[1])])
    cases = []
    for combo in itertools.product(*axes):
        rk, pk, ids = {}, {}, []
        for names, rv, pv in combo:
            rvals = rv if len(names) > 1 else (rv,)
            pvals = pv if len(names) > 1 else (pv,)
            rk.update(zip(names, rvals))
            pk.update(zip(names, pvals))
            ids.append("-".join(f"{_id(a)}/{_id(b)}" if a != b
                                else _id(a) for a, b in zip(rvals, pvals)))
        cases.append(("-".join(ids), rk, pk))
    return cases


class _Fixtures:
    """The reference module's own fixtures, made for each package as
    their scope says (module-scoped ones once per process and fixture
    parameters, function-scoped ones each run; ``request.param`` from the
    case being run), and the built-in ones each run needs."""

    def __init__(self):
        self._cache: dict = {}

    def resolve(self, mod, name, mp, tmp_factory, fparams):
        if name == "monkeypatch":
            return mp
        if name == "tmp_path":
            return tmp_factory.mktemp("mirror")
        if name in fparams.get(_BUILTINS, {}):
            return fparams[_BUILTINS][name]
        fx = getattr(mod, name)
        scoped = fx._fixture_function_marker.scope != "function"
        key = (mod.__name__, name, fparams.get(_DEFAULT), tuple(
            (f, repr(fparams[f])) for f in _fixture_closure(mod, name)
            if f in fparams))
        if scoped and key in self._cache:
            return self._cache[key]
        fn = fx._get_wrapped_function()
        kwargs = {}
        for arg in inspect.signature(fn).parameters:
            if arg == "request":
                kwargs[arg] = types.SimpleNamespace(param=fparams.get(name))
            else:
                kwargs[arg] = self.resolve(mod, arg, mp, tmp_factory,
                                           fparams)
        out = fn(**kwargs)
        if inspect.isgenerator(out):
            out = next(out)
        if scoped:
            self._cache[key] = out
        return out


_FIXTURES = _Fixtures()


def _is_fixture(mod, name) -> bool:
    return hasattr(getattr(mod, name, None), "_fixture_function_marker")


def _fixture_closure(mod, name) -> list[str]:
    """The fixtures ``name`` depends on, itself included."""
    out, todo = [], [name]
    while todo:
        n = todo.pop()
        if n in out or not _is_fixture(mod, n):
            continue
        out.append(n)
        fn = getattr(mod, n)._get_wrapped_function()
        todo += list(inspect.signature(fn).parameters)
    return out


def _fixture_params(mod, fn) -> list[tuple[str, tuple]]:
    """(fixture, its params) of every parametrized fixture ``fn`` uses."""
    names = []
    for arg in inspect.signature(fn).parameters:
        for n in _fixture_closure(mod, arg):
            if n not in names:
                names.append(n)
    return [(n, getattr(mod, n)._fixture_function_marker.params)
            for n in names
            if getattr(mod, n)._fixture_function_marker.params]


def _run_one(pkg, mod, fn, params, default_backend, tmp_factory,
             builtins=None):
    """Run one test function on one package; returns its record.
    ``builtins`` holds pytest's own fixtures the test asks for."""
    import importlib
    compile_mod = importlib.import_module(f"{pkg}.engine.compile")
    mp = pytest.MonkeyPatch()
    try:
        if default_backend is not None:
            _with_default_backend(pkg, default_backend, mp)
        compile_mod.PLAN_CACHE.clear()
        rec = _Recorder(pkg, mp)
        kwargs = dict(params)
        if getattr(fn, "is_hypothesis_test", False):
            # Both packages' runs draw the same examples.
            import hypothesis
            fn = hypothesis.seed(_HYPOTHESIS_SEED)(fn)
        fparams = {**kwargs.pop(_FIXTURE_PARAMS, {}),
                   _DEFAULT: default_backend, _BUILTINS: builtins or {}}
        for name in inspect.signature(fn).parameters:
            if name not in kwargs:
                kwargs[name] = _FIXTURES.resolve(mod, name, mp,
                                                 tmp_factory, fparams)
        fn(**kwargs)
        return rec.log
    finally:
        mp.undo()


# Keys of a run's fixture parameters: the fixtures' own, and the default
# backend the run patched in (a fixture made under one default must not
# serve a run under another).
_FIXTURE_PARAMS = "__fixture_params__"
_DEFAULT = "__default_backend__"
_BUILTINS = "__builtins__"
_HYPOTHESIS_SEED = 20260101


def _cases(ref_mod, port_mod, ref_fn, port_fn) -> list[tuple[str, dict,
                                                              dict]]:
    """The parametrisations of a test and of the fixtures it uses, the
    reference's beside the port's."""
    cases = _param_cases(ref_fn, port_fn)
    rf, pf = _fixture_params(ref_mod, ref_fn), \
        _fixture_params(port_mod, port_fn)
    for (name, rvals), (_, pvals) in zip(rf, pf):
        grown = []
        for cid, rk, pk in cases:
            for rv, pv in zip(rvals, pvals):
                rfix = {**rk.get(_FIXTURE_PARAMS, {}), name: rv}
                pfix = {**pk.get(_FIXTURE_PARAMS, {}), name: pv}
                vid = str(rv) if rv == pv else f"{rv}/{pv}"
                grown.append(("-".join(x for x in (cid, vid) if x),
                              {**rk, _FIXTURE_PARAMS: rfix},
                              {**pk, _FIXTURE_PARAMS: pfix}))
        cases = grown
    return cases


def mirror(name: str, numpy_too=(), omit=None) -> dict:
    """Test functions holding the port to the reference module
    ``tests/<name>.py``, one per reference test and under its name. The
    tests named in ``numpy_too`` use the default backend and run on
    ``numpy``/``numpy`` as well as ``jit``/``torch``. ``omit`` maps the
    name of a reference test that checks the JAX package's own machinery
    to the reason it has no mirror."""
    import importlib
    ref_mod = importlib.import_module(name)
    port_mod = port_module(name)
    out = {}
    omit = omit or {}
    names = [n for n, f in vars(ref_mod).items()
             if n.startswith("test_") and callable(f)]
    unknown = (set(numpy_too) | set(omit)) - set(names)
    assert not unknown, f"{name} has no tests {sorted(unknown)}"
    assert all(omit.values()), "each omitted test needs its reason"
    for tname in names:
        if tname in omit:
            continue
        ref_fn, port_fn = getattr(ref_mod, tname), getattr(port_mod, tname)
        cases = []
        for cid, rk, pk in _cases(ref_mod, port_mod, ref_fn, port_fn):
            cases.append(pytest.param(None, rk, pk, id=cid or "jit/torch"))
            if tname in numpy_too:
                cases.append(pytest.param(
                    "numpy", rk, pk,
                    id=(cid + "-" if cid else "") + "numpy"))

        def test(mirror_env, tmp_path_factory, capsys, default, ref_kw,
                 port_kw, _ref=ref_fn, _port=port_fn):
            builtins = {"capsys": capsys}
            ref_log = _run_one("repro", ref_mod, _ref, ref_kw, default,
                               tmp_path_factory, builtins)
            port_log = _run_one(_PORT_PREFIX, port_mod, _port, port_kw,
                                default, tmp_path_factory, builtins)
            assert_records_equal(ref_log, port_log)

        test.__name__ = tname
        test.__doc__ = ref_fn.__doc__
        out[tname] = pytest.mark.parametrize(
            "default, ref_kw, port_kw", cases)(test)
    return out


# ---------------------------------------------------------------------------
# Checks of the mirror itself
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_reference():
    """Nothing under ``src/repro_torch/`` and not ``chip_smoke.py``
    imports JAX or the reference package."""
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)"
        r"(?!_))", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    assert len(files) > 50
    found = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
             for p in files for m in pattern.finditer(p.read_text())]
    assert found == []


def test_port_source_retargets_imports_and_backend():
    src = ('from repro.engine import datagen\nimport repro.core.chaos\n'
           'code = "from repro.engine import plans"\n'
           'x = Coordinator(store, backend="jit")\n')
    assert port_source(src) == (
        'from repro_torch.engine import datagen\n'
        'import repro_torch.core.chaos\n'
        'code = "from repro_torch.engine import plans"\n'
        'x = Coordinator(store, backend="torch")\n')


def _chaos_run(pkg, backend, seed):
    import importlib
    chaos_mod = importlib.import_module(f"{pkg}.core.chaos")
    ss = importlib.import_module(f"{pkg}.core.storage_service")
    adaptive = importlib.import_module(f"{pkg}.engine.adaptive")
    lg = importlib.import_module(f"{pkg}.engine.logical")
    from repro.core.storage_service import ObjectStore as RefStore
    from repro.engine import datagen
    from repro_torch.core.storage_service import copy_objects
    src = RefStore()
    keys = {"lineitem": datagen.load_table(src, "lineitem", 4000, 8),
            "orders": datagen.load_table(src, "orders", 800, 8)}
    store = ss.ObjectStore()
    copy_objects(src, store)
    chaos = chaos_mod.ChaosPolicy(seed=seed, drop_prob=0.05,
                                  kill_prob=0.1, slow_prob=0.15)
    store.chaos = chaos
    coord = adaptive.AdaptiveCoordinator(
        store, policy=adaptive.ADAPTIVE, mode="provisioned",
        backend=backend, rng_seed=seed, chaos=chaos)
    coord.kv_store.chaos = chaos
    for t, k in keys.items():
        coord.register_table(t, k)
    q = (lg.scan("lineitem", ["l_orderkey", "l_extendedprice",
                              "l_discount"])
         .join(lg.scan("orders", ["o_orderkey", "o_totalprice"]),
               on=("l_orderkey", "o_orderkey"))
         .select("l_orderkey", (lg.col("l_extendedprice")
                                * (1 - lg.col("l_discount")))
                 .alias("revenue"), "o_totalprice")
         .group_by("l_orderkey").agg(lg.sum_("revenue").alias("revenue"))
         .collect("chaos_q", shuffle_partitions=8))
    return coord.run(q, query_id="chaos")


@pytest.mark.parametrize("backends", [("numpy", "numpy"), ("jit", "torch")],
                         ids=["numpy", "jit-torch"])
def test_changed_chaos_seed_fails_the_trace_equality(mirror_env, backends):
    """The equality the mirror asserts is not vacuous: the same seed
    gives equal records, and the port under another chaos seed differs
    from the reference in its adaptive trace and modeled runtime."""
    rb, tb = backends
    ref = _chaos_run("repro", rb, 0)
    assert ref.adaptive_trace
    assert_query_results_equal(ref, _chaos_run(_PORT_PREFIX, tb, 0))
    other = _chaos_run(_PORT_PREFIX, tb, 1)
    assert other.adaptive_trace != ref.adaptive_trace
    with pytest.raises(AssertionError):
        assert_query_results_equal(ref, other)
    with pytest.raises(AssertionError):
        assert_records_equal([("query", ref)], [("query", other)])
