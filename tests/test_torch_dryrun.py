"""The dry-run tooling of the port on the CPU: K4 as a registered op and
the op-level cost (``launch/op_cost.py``).

* K4's op ``repro_torch::flash_attention``: its fake implementation's
  shapes and dtypes, its FLOP formula against the (query, key) pairs it
  states, and its CPU implementation bit for bit against
  ``flash_attention_plain``.
* ``op_cost`` over a fake process group of 512 ranks in this process
  (destroyed after the module): a sharded product counts its local
  product; a group spanning ranks 0 and 256 counts as DCI and one spanning
  0 and 8 as network; the trip-count fit (three layer counts, two
  microbatch counts) equals a full trace of a SMOKE LM train cell on a
  ``(2, 2)`` mesh (FLOPs, bytes and collective bytes exactly, the peak
  within :data:`PEAK_RTOL`).

The banded cell against the reference's HLO, the CLI and the report:
``tests/test_torch_dryrun_cli.py``.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

# the fitted peak against a full trace: the peak is not affine in the
# layers (the largest transient moves), measured within 1% here
PEAK_RTOL = 0.05


# ---------------------------------------------------------------------------
# K4 as a registered op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_k4_op_fake_gives_out_and_lse_shapes(with_lse, device):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(2, 7, 8, 64, dtype=torch.bfloat16, device=device)
        k = torch.empty(2, 9, 2, 64, dtype=torch.bfloat16, device=device)
        out, lse = fa.flash_attention_op(q, k, k, None, True, 2, with_lse, 512, 1024)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert out.device.type == device
    assert lse.dtype == torch.float32
    assert tuple(lse.shape) == ((2, 7, 8) if with_lse else (0,))


@pytest.mark.parametrize("Tq,Tk,q_offset,causal", [
    (16, 16, 0, True), (1, 64, 63, False), (5, 40, 10, True), (8, 4, 0, True),
    (4, 10, -3, True), (6, 10, 7, True)])
def test_k4_flop_formula_counts_the_causal_pairs(Tq, Tk, q_offset, causal):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B, H, KV, D = 2, 4, 2, 32
    pairs = sum(max(0, min(q_offset + i + 1, Tk)) if causal else Tk for i in range(Tq))
    assert fa.causal_pairs(Tq, Tk, q_offset, causal) == pairs
    with FakeTensorMode():
        q = torch.empty(B, Tq, H, D)
        k = torch.empty(B, Tk, KV, D)
        with FlopCounterMode(display=False) as fc:
            fa.flash_attention_op(q, k, k, None, causal, q_offset, False, 512, 1024)
    assert fc.get_total_flops() == 4 * B * H * D * pairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_op_on_the_cpu_is_the_plain_version_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 6, 4, 16, generator=g).to(dtype)
    k = torch.randn(2, 20, 2, 16, generator=g).to(dtype)
    v = torch.randn(2, 20, 2, 16, generator=g).to(dtype)
    lengths = torch.tensor([20, 13], dtype=torch.int32)
    out, lse = fa.flash_attention_op(q, k, v, lengths, True, 10, True, 4, 8)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True, q_offset=10,
                                              kv_length=lengths, block_q=4, block_kv=8,
                                              return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    out, lse = fa.flash_attention_op(q, k, v, None, False, 0, False, 512, 1024)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, causal=False))
    assert lse.shape == (0,)


def test_combine_at_one_rank_gives_k4s_output_bit_for_bit():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 3, 4, 16, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 12, 2, 16, generator=g).to(torch.bfloat16)
    out, lse = fa.flash_attention_op(q, k, k, None, True, 9, True, 512, 1024)
    assert torch.equal(fa.combine_key_ranges(out, lse, []), out)


def test_combine_of_two_key_ranges_equals_the_whole_range():
    """The combine's arithmetic over two halves of the keys (a rank's
    partials, here in one process) against one call over all of them."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    v = torch.randn(2, 40, 2, 16, generator=g)
    parts = [fa.flash_attention_op(q, k[:, a:b], v[:, a:b], None, False, 0, True, 512, 1024)
             for a, b in ((0, 25), (25, 40))]
    lse = torch.stack([p[1] for p in parts])
    top = lse.amax(0)
    w = torch.exp(lse - top)
    got = (sum(w[i][..., None] * parts[i][0] for i in range(2))
           / w.sum(0)[..., None])
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v, causal=False),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# op_cost over a fake group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist

    from repro_torch.distributed.world import init_fake_group, initialized

    assert not initialized()
    init_fake_group(512)
    yield
    dist.destroy_process_group()


def test_sharded_product_counts_its_local_product(fake_world):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_cost import measure

    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(131072 // 32, 8192), mesh,
                               [Shard(0), Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(8192, 8192 // 16), mesh,
                               [Replicate(), Replicate(), Shard(1)], run_check=False)
        cost, out = measure(lambda x, y: x @ y, [a, b])
    assert cost.flops == 2 * 4096 * 8192 * 512
    assert tuple(out.to_local().shape) == (4096, 512)
    assert cost.n_collectives == 0


@pytest.mark.parametrize("ranks,field", [
    ([0, 256], "dci_bytes"), ([0, 8], "network_bytes"), ([0, 1], "nvlink_bytes"),
    ([0, 255], "ici_bytes")])
def test_group_ranks_decide_the_link(fake_world, ranks, field):
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_cost import measure

    group = dist.new_group(ranks)
    with FakeTensorMode():
        cost, _ = measure(lambda t: dist.all_reduce(t, group=group), [torch.empty(1000)])
    assert getattr(cost, field) == 4000
    assert cost.by_collective == {"all-reduce": 4000.0} and cost.n_collectives == 1
    other = {"dci_bytes": "ici_bytes", "ici_bytes": "dci_bytes",
             "network_bytes": "nvlink_bytes", "nvlink_bytes": "network_bytes"}[field]
    assert getattr(cost, other) == 0


def test_trip_count_fit_equals_a_full_trace(fake_world):
    """glm4-9b SMOKE's train cell on a (2, 2) mesh at 4 layers in 4
    microbatches, traced whole, against the fit of six small traces."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import cells
    from repro_torch.launch.dryrun import measure_cell
    from repro_torch.launch.op_cost import LINEAR_FIELDS, extrapolate

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))

    def cost(layers, mbs):
        cell = cells.build_cell("glm4-9b", "train_4k", mesh, smoke=True, depth=layers,
                                microbatches=mbs, batch=2)
        return measure_cell(cell, "cpu")

    full = cost(4, 4)
    fit = extrapolate({(l, m): cost(l, m) for l in (1, 2, 3) for m in (2, 3)}, (4, 4))
    for f in LINEAR_FIELDS:
        assert getattr(fit, f) == getattr(full, f), f
    assert fit.by_collective == full.by_collective
    assert fit.op_counts == full.op_counts == {"repro_torch.flash_attention": 4 * 4}
    assert full.flops > 0 and full.nvlink_bytes > 0
    assert fit.peak_bytes == pytest.approx(full.peak_bytes, rel=PEAK_RTOL)


def test_vocab_split_loss_holds_no_global_logits(fake_world):
    """A repair of the sharded LM step: with the vocab split over
    ranks, the loss's backward made the gradient of the whole ``(B, T, V)``
    logits on every rank (``gather``'s backward zero-fills the global
    shape).  Under loss parallelism no storage a rank makes reaches the
    global float32 logits' size (a (1, 4) mesh, vocab 16,384)."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.launch.op_cost import measure
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps

    mod = registry.get_arch("glm4-9b")
    cfg = dataclasses.replace(mod.SMOKE, vocab_size=16_384,
                              sharding_rules=dict(mod.CONFIG.sharding_rules))
    rules = dict(cfg.sharding_rules)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
    B, T = 8, 32
    with FakeTensorMode():
        params = transformer.init_params(cfg, None, "cpu", dtype=torch.float32)
        state = sharding.distribute_state(steps.init_train_state(params, opt_lib.adamw(3e-4)),
                                          transformer.logical_axes(cfg), rules, mesh)
        rows = sharding.batch_placements(rules, mesh)
        tok = torch.zeros((B, T), dtype=torch.int64)
        batch = sharding.place_tree({"tokens": tok, "labels": tok}, {"tokens": rows,
                                                                     "labels": rows}, mesh)
        with sharding.use_mesh_rules(mesh, rules):
            cost, _ = measure(steps.build_lm_train_step(cfg, opt_lib.adamw(3e-4)),
                              [state, batch])
    logits_bytes = B * T * cfg.vocab_size * 4
    assert 0 < cost.largest_bytes < logits_bytes
