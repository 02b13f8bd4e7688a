"""The port's ``lm_generate`` entrypoint on the CPU, and the port's isolation
from JAX and from the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from polyaxon_tpu_torch.builtins.trainers import lm_generate
from polyaxon_tpu_torch.tracking.context import Context

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
             seq=64, batch=2, prompt_len=8, max_new_tokens=6)


@pytest.mark.parametrize("extra", [{}, {"quantize": "int8", "n_kv_heads": 2},
                                   {"temperature": 0.8}], ids=["greedy", "int8-gqa", "sampled"])
def test_lm_generate_logs_the_three_metrics(extra):
    records = []
    ctx = Context(params=dict(SMALL, device="cpu", **extra), seed=3, records=records)
    out = lm_generate(ctx)
    assert tuple(out.shape) == (2, 6) and int(out.max()) < 256
    metrics = [r["values"] for r in records if r["kind"] == "metric"]
    assert len(metrics) == 1
    assert set(metrics[0]) == {"decode_tokens_per_s", "prefill_s", "generated"}
    assert metrics[0]["generated"] == 12 and metrics[0]["decode_tokens_per_s"] > 0
    assert any("lm_generate done" in r["line"] for r in records if r["kind"] == "log")


def test_lm_generate_is_seeded():
    run = lambda: lm_generate(Context(params=dict(SMALL, device="cpu"), seed=5, records=[]))
    assert torch.equal(run(), run())


def test_lm_generate_target_is_not_ported():
    ctx = Context(params=dict(SMALL, device="cpu", target="some-run"), records=[])
    with pytest.raises(NotImplementedError, match="checkpoint restore"):
        lm_generate(ctx)


def test_lm_generate_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent path; a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_generate(Context(params=dict(SMALL), records=[]))


def test_context_writes_json_lines_without_a_record_list(capsys):
    ctx = Context(params={"a": 1})
    ctx.log_metrics(step=2, loss=0.5)
    ctx.log_text("hello")
    out = capsys.readouterr().out.splitlines()
    assert out == ['{"kind": "metric", "step": 2, "values": {"loss": 0.5}}',
                   '{"kind": "log", "line": "hello"}']
    assert ctx.get_param("a") == 1 and ctx.get_param("b", 7) == 7 and ctx.is_leader


def _port_files():
    return sorted((REPO / "polyaxon_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "polyaxon_tpu", "flax", "optax"), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}"
            )


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import polyaxon_tpu_torch.builtins.trainers, polyaxon_tpu_torch.models\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'polyaxon_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
