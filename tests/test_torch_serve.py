"""``launch/serve.py`` against ``repro/launch/serve.py`` at smoke width:
the same weights (crossed by ``convert.params``) and prompts give the same
tokens at float32 for every family the reference's server serves, waves,
left padding and eos included; then the command line and
``examples/serve_lm_torch.py --device cpu``."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.serve import BatchedServer as JServer
from repro.models.registry import ModelBundle as JBundle

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import ModelBundle as TBundle

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


ENV = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "PATH": "/usr/bin:/bin"}


@pytest.fixture(scope="module", autouse=True)
def reference_example():
    """examples/serve_lm.py started with the module's first test, so that
    it runs beside the others; the example test reads its output."""
    proc = subprocess.Popen([sys.executable, "examples/serve_lm.py"],
                            stdout=subprocess.PIPE, text=True, cwd=str(ROOT),
                            env=ENV)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def _bundles(arch: str):
    jc = jconfigs.smoke_config(arch).scaled(dtype="float32")
    tc = tconfigs.smoke_config(arch).scaled(dtype="float32")
    jb, tb = JBundle(jc), TBundle(tc)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, tb, convert.params(tc, jax.tree.map(np.asarray, jp),
                                      "cpu")


def _prompts(vocab: int, n: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab - 1, rs.randint(4, 16)) for _ in range(n)]


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b",
                                  "qwen3-moe-30b-a3b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_generate_same_tokens_at_float32(arch):
    """Ten prompts in waves of four (the last wave short), 12 new tokens
    each: the port serves the reference's tokens, one for one, for the
    dense, MoE, SSM and hybrid families (the reference's server passes no
    frame embeddings, so it serves no encoder-decoder)."""
    jb, jp, tb, tp = _bundles(arch)
    prompts = _prompts(jb.cfg.vocab_size, 10)
    # No slot stops (eos has its own test below): every request decodes
    # all 12 tokens, in both packages.
    want = JServer(jb, jp, batch=4, max_seq=64, eos_id=-1).generate(
        prompts, max_new=12)
    got = tserve.BatchedServer(tb, tp, batch=4, max_seq=64,
                               eos_id=-1).generate(prompts, max_new=12)
    assert got == want
    assert all(len(o) == 12 for o in got)


def test_eos_stops_a_slot():
    """With eos set to a token the reference emits, the slots that emit it
    stop there, in both packages."""
    jb, jp, tb, tp = _bundles("qwen3-4b")
    prompts = _prompts(jb.cfg.vocab_size, 5, seed=1)
    free = JServer(jb, jp, batch=2, max_seq=64).generate(prompts, max_new=8)
    eos = free[0][2]
    want = JServer(jb, jp, batch=2, max_seq=64, eos_id=eos).generate(
        prompts, max_new=8)
    got = tserve.BatchedServer(tb, tp, batch=2, max_seq=64,
                               eos_id=eos).generate(prompts, max_new=8)
    assert got == want
    assert got[0] == free[0][:3]
    assert any(len(o) < 8 for o in got)


def _run(args):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, check=True, cwd=str(ROOT),
                          env=ENV).stdout


def test_command_line_on_the_cpu():
    out = _run(["-m", "repro_torch.launch.serve", "--requests", "3",
                "--batch", "2", "--max-new", "4", "--device", "cpu"])
    assert "served 3 requests" in out and "on cpu" in out


def test_example_serves_the_reference_prompts(reference_example):
    """examples/serve_lm_torch.py --device cpu prints a line per prompt of
    examples/serve_lm.py, with the same prompt lengths and 12 in-vocabulary
    tokens each.  The example is bfloat16, where the two packages' logits
    differ by rounding and a greedy argmax near a tie can pick another
    token, so the tokens themselves are compared at float32 above."""
    got = _run(["examples/serve_lm_torch.py", "--device", "cpu"])
    want = reference_example.communicate()[0]
    assert reference_example.returncode == 0
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines) == 10
    vocab = tconfigs.smoke_config("qwen3-4b").vocab_size
    for g, w in zip(g_lines, w_lines):
        assert g.split(" -> ")[0] == w.split(" -> ")[0]
        toks = [int(t) for t in g.split(" -> ")[1].strip("[]").split(",")]
        assert len(toks) == 12 and all(0 <= t < vocab for t in toks)
