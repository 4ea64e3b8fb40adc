"""The local-shard forms of ``distributed/shard_ops.py`` that the dry
run's serving and SSM cells take, with values: on a 2 x 2 ("data",
"model") mesh of 4 gloo worker processes (``tests/_torch_dist.py``),
decode attention with the cache split by kv heads, by its sequence over
"model" (each rank attends its own slots; the softmax is combined across
ranks), and over both mesh dims (a long-context cache), the plain decode
and the ring buffer's, the SSD's chunked scan on (batch, head) shards
and its decode readout, and the RG-LRU gates' row-parallel product with its gradients, each
against the plain function on the whole inputs; and whisper's train
loss and gradients on the mesh against the unsharded trainer's."""
import os
import socket
import sys

import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist  # noqa: E402

# float32; the sequence split sums the softmax in another order
RTOL = 1e-5


@pytest.fixture(scope="module")
def gaps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("shard_ops"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_torch_dist.shard_ops_cases, args=(4, port, out), nprocs=4,
             join=True)
    return torch.load(os.path.join(out, "rank0.pt"))


@pytest.mark.parametrize("layout", ["kv_heads", "sequence", "long_context"])
def test_decode_attention_on_local_shards(gaps, layout):
    """Three cache positions (a rank's slots all valid, some, none) and a
    window with a softcap, then the ring buffer's decode."""
    cases = {k: v for k, v in gaps.items()
             if "/" in k and k.split("/")[1] == layout}
    assert len(cases) == 4
    for name, gap in cases.items():
        assert gap <= RTOL, (name, gap)


def test_ssd_scan_on_local_shards(gaps):
    """The chunked scan on (batch, head) shards; y keeps (batch, heads);
    and the decode step's readout of a state split on its head_dim."""
    assert gaps["ssd_scan"] <= RTOL and gaps["ssd_readout"] <= RTOL
    assert gaps["ssd_scan_layout"] == [0, 2]


def test_ssd_scan_state_on_local_shards(gaps):
    """The scan's final carry after 27 of 32 positions (the rest a right
    padding) on (batch, head) shards: it keeps (batch, heads) on its
    (B, H, P, N) dims."""
    assert gaps["ssd_scan_state"] <= RTOL
    assert gaps["ssd_scan_state_layout"] == [0, 1]


def test_whisper_loss_and_gradients_on_a_mesh(gaps):
    """whisper-large-v3's smoke loss and gradients on the 2 x 2 mesh
    within 1e-5 of the unsharded trainer's (the gradients relative to
    the tree's largest entry: its key biases' gradients are rounding
    noise), and the first decoder layer's input holds no pending sum:
    the loss reduces the vocab-parallel embedding's partial sums before
    any layer (torch 2.11 refuses a biased projection of them)."""
    assert gaps["whisper_loss"] <= RTOL
    assert gaps["whisper_grads"] <= RTOL
    assert gaps["whisper_first_layer_input"]
    assert not gaps["whisper_partial"], gaps["whisper_first_layer_input"]


def test_split_matmul_and_its_gradients(gaps):
    """x (batch over "data", K over "model") @ w (K over "model"), the
    partial sums reduce-scattered; dx and dw on the local shards."""
    for name in ("split_matmul", "split_matmul_dx", "split_matmul_dw"):
        assert gaps[name] <= RTOL, (name, gaps[name])
