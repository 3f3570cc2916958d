"""Tensor-parallel serving rules that need no JAX reference, and its
``gpu`` case (this file imports no JAX: the card's machine has none).

  * the transport follows the group's backend and the device, and the
    helpers of ``parallel.tp`` are identities outside a TP context;
  * a one-rank group sums and gathers to the identity and counts no
    bytes; ``model_only_pspec`` / ``model_dim`` read a description;
  * ``parallel.ranks.run_ranks`` returns each rank's result, and a rank
    that raises or hangs fails the call within its own deadline;
  * on the card (``gpu``): tp=1 over NCCL at 2 layers of nemotron-4-15b's
    full width: ``Server(mesh=make_host_mesh())``'s captured scan (an
    NCCL all-reduce in its graph) equals the eager loop and the meshless
    server bit for bit, with exact launches and zero counted bytes.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.launch import roofline
from repro_torch.launch.mesh import CANONICAL_AXES, Mesh, make_host_mesh
from repro_torch.launch.serve import Server
from repro_torch.models import transformer as T
from repro_torch.parallel import ranks
from repro_torch.parallel import tp as tplib

import torch_tp_ranks as R


def _mesh(backend, device):
    return Mesh(shape=(1, 2), axis_names=CANONICAL_AXES[2],
                device=torch.device(device), group=None, rank=0,
                backend=backend)


@pytest.mark.parametrize("backend, device, transport", [
    ("nccl", "cuda", "nccl"), ("gloo", "cpu", "gloo"),
    ("gloo", "cuda", "gloo-host-staged")])
def test_transport_follows_backend_and_device(backend, device, transport):
    ctx = _mesh(backend, device).tp_context()
    assert (ctx.transport, ctx.size, ctx.rank, ctx.axis) == (
        transport, 2, 0, "model")


def test_helpers_are_identities_outside_tp():
    x = torch.arange(6.0).reshape(2, 3)
    assert tplib.active() is None
    assert tplib.psum_partial(x) is x and tplib.all_gather_cols(x) is x
    assert tplib.shard_offset(7) == 0


def test_one_rank_group_is_an_exact_identity_and_moves_nothing():
    mesh = make_host_mesh(device="cpu")
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    tplib.reset_coll_bytes()
    with tplib.tensor_parallel(mesh.tp_context()):
        assert tplib.active().size == 1 and tplib.shard_offset(7) == 0
        s = tplib.psum_partial(x.clone())
        g = tplib.all_gather_cols(x)
    assert torch.equal(s, x) and torch.equal(g, x)
    assert tplib.collective_bytes() == roofline.tp_step_collectives(
        tcfg.get_smoke_config("nemotron-4-15b"), batch=1, tp=1)
    with pytest.raises(ValueError, match="transport"):
        with tplib.tensor_parallel(dataclasses.replace(
                mesh.tp_context(), transport="mpi")):
            pass


def test_model_only_pspec_reads_a_description():
    assert tplib.model_only_pspec((None, "model")) == (None, "model")
    assert tplib.model_only_pspec((("pod", "data"), None)) == ()
    assert tplib.model_only_pspec((("data", "model"), "data")) == ("model",)
    assert tplib.model_dim((None, "model")) == 1
    assert tplib.model_dim(("model",)) == 0 and tplib.model_dim(()) is None
    cfg = tcfg.get_smoke_config("deepseek-v3-671b")
    specs = T.param_pspecs(cfg)
    assert specs["embed"] == ("model",)
    dims = {tplib.model_dim(s) for layer in specs["layers"]
            for s in layer["attn"].values()}
    assert dims == {None, 0, 1}


def test_run_ranks_returns_each_ranks_result(tmp_path):
    assert ranks.run_ranks(R.echo_sum, 2, timeout=60,
                           store_dir=str(tmp_path)) == [3.0, 3.0]


@pytest.mark.parametrize("how", ["fail", "hang"])
def test_run_ranks_fails_a_bad_rank_within_its_deadline(tmp_path, how):
    kw = {"fail_rank": 1} if how == "fail" else {"hang_rank": 1}
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="fails on purpose" if how == "fail"
                       else "did not finish within 8"):
        ranks.run_ranks(R.echo_sum, 2, timeout=8, store_dir=str(tmp_path),
                        args=(kw.get("fail_rank"), kw.get("hang_rank")))
    assert time.monotonic() - t0 < 30


@pytest.mark.gpu
def test_host_mesh_over_nccl_captured_equals_eager():
    """tp=1 over NCCL at 2 layers of nemotron-4-15b's full width: the
    captured scan (an NCCL all-reduce in its graph) equals the eager
    loop and the meshless server bit for bit, with exact launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and capture run only on "
                    "the card")
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import graphs
    from repro_torch.launch import mesh as mesh_lib

    try:
        _nccl_case(kops, graphs)
    finally:
        mesh_lib.destroy()


def _nccl_case(kops, graphs):
    cfg = dataclasses.replace(tcfg.get_config("nemotron-4-15b"),
                              num_layers=2, use_pallas=True)
    params = T.init(cfg, seed=0, device="cuda")
    mesh = make_host_mesh()
    assert mesh.transport == "nccl"
    srv = Server(cfg, params, max_len=64, mesh=mesh)
    solo = Server(cfg, params, max_len=64)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 16))
    kops.reset_launch_counts()
    tplib.reset_coll_bytes()
    cap = srv.generate(prompts, 9).tokens.cpu().numpy()
    counts = kops.launch_counts()
    replay = srv.generate(prompts, 9).tokens.cpu().numpy()
    with graphs.disable_capture():
        eager = srv.generate(prompts, 9).tokens.cpu().numpy()
    meshless = solo.generate(prompts, 9).tokens.cpu().numpy()
    np.testing.assert_array_equal(cap, eager)
    np.testing.assert_array_equal(replay, eager)
    np.testing.assert_array_equal(cap, meshless)
    assert counts["sidebar_mlp"] == 2 * 9 and counts["paged_gqa"] == 0
    prog = srv._decode_scans[(8, srv.tp.mesh_key)]
    assert (prog.captures, prog.replays) == (1, 1)
    assert tplib.collective_bytes() == roofline.tp_step_collectives(
        cfg, batch=4, tp=1)
