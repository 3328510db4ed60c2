"""The port's six examples (``repro_torch.examples``) on the CPU.

``cost_planner``, ``logical_api_quickstart`` and
``concurrent_serving_quickstart`` print what the reference's examples
print, run in the same process under ``test_torch_parity``'s
``mirror_env`` (one pinned bench profile, the port's devices on the
CPU): the same text, but for the backend's name (``jit`` in the
reference, ``torch`` in the port), the host wall times the serving
example prints, and float aggregates, which may differ within the
backends' float contract (rtol 1e-6). ``quickstart`` at 4 steps
completes and writes its checkpoint manifests; ``elastic_training`` is
preempted at step 12, restarts from its step-10 checkpoint and
completes; ``serverless_serving`` answers 10 requests of 8 tokens.
"""
import importlib
import math
import re
import sys

import pytest

from test_torch_parity import REPO, mirror_env  # noqa: F401

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CPU = ["--device", "cpu"]


def _reference_main(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _as_port(text: str) -> str:
    """Reference output with the backend named as the port names it and
    host wall times blanked."""
    text = text.replace("backend=jit", "backend=torch")
    text = text.replace("[jit]", "[torch]")
    return _walls(text)


def _walls(text: str) -> str:
    return re.sub(r"wall \d+\.\d+s", "wall _s", text)


NUMBER = re.compile(r"\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?")


def assert_same_text(got: str, want: str) -> None:
    """The same words and numbers; a number printed with a fraction
    within the float contract of ``docs/BACKENDS.md`` (rtol 1e-6: the
    torch and jit backends sum float32 in other orders)."""
    assert NUMBER.split(got) == NUMBER.split(want)
    for a, b in zip(NUMBER.findall(got), NUMBER.findall(want)):
        if a != b:
            assert "." in b, (a, b)
            assert float(a.replace(",", "")) == pytest.approx(
                float(b.replace(",", "")), rel=1e-6), (a, b)


@pytest.mark.parametrize("name", ["cost_planner", "logical_api_quickstart",
                                  "concurrent_serving_quickstart"])
def test_example_prints_the_reference_output(mirror_env, capsys, name):
    _reference_main(name)()
    want = _as_port(capsys.readouterr().out)
    port = importlib.import_module(f"repro_torch.examples.{name}")
    port.main([] if name == "cost_planner" else CPU)
    got = _walls(capsys.readouterr().out)
    assert want.strip()
    assert_same_text(got, want)


def test_query_examples_default_to_the_card():
    """Without ``--device`` the query examples ask for the card, which
    this machine does not have."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.examples import logical_api_quickstart
    with pytest.raises(RuntimeError):
        logical_api_quickstart.main([])


def test_quickstart_completes_and_writes_checkpoints(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--steps", "4", *CPU])
    assert out["status"] == "done" and out["steps"] == 4
    assert sorted(out["manifests"]) == ["ckpt-opt/step-00000004/MANIFEST.json",
                                        "ckpt/step-00000004/MANIFEST.json"]
    assert "arch=internlm2-1.8b status=done" in capsys.readouterr().out


def test_elastic_training_resumes_from_step_10(capsys):
    from repro_torch.examples import elastic_training
    out = elastic_training.main(CPU)
    assert out["ranks"] == 1
    assert out["phase1"]["status"] == "preempted"
    assert out["phase1"]["at_step"] == 12
    assert out["phase1"]["resumable_from"] == 10
    assert out["phase2"]["status"] == "done"
    steps = [m["step"] for m in out["phase2"]["metrics"]]
    assert steps == [12, 14, 16, 18, 20]
    assert all(math.isfinite(m["loss"]) for m in out["phase2"]["metrics"])
    assert "simulated preemption at step 12" in capsys.readouterr().out


def test_serverless_serving_answers_ten_requests():
    from repro_torch.examples import serverless_serving
    out = serverless_serving.main(CPU)
    done = out["done"]
    assert sorted(r.request_id for r in done) == list(range(10))
    for r in done:
        assert r.completion.shape == (8,)
        assert 0 <= r.completion.min() and \
            r.completion.max() < out["vocab_size"]
    assert out["cost"]["chips"] == 1
