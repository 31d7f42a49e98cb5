"""Port: the LM training step on a (data, model) mesh of ranks, held to
the one-device step.

One spawned world of 4 gloo ranks on the CPU (`launch.dist.spawn`, as
`test_torch_distributed.py`) runs every case: `train_lib.make_train_step`
on this rank's blocks (`params.shard_tree`) and rows (`local_batch`),
FSDP over ``data``, tensor and expert parallelism over ``model``.  The
test process meanwhile runs the one-device steps: the port's ``mesh=None``
step, and for gemma-7b the reference's unsharded step
(``repro.training.train_lib``, its own test's case: SGD at lr 0.1, no
clip, the reference's parameters carried over by `io.convert`).

Tolerances, all float32: the loss within 1e-5 relative; each gradient
leaf within 1e-4 of its largest magnitude; the parameters after one step
within 1e-4 of their largest (after AdamW's first step only where the
gradient's sign is resolved, |g| above the gradient tolerance: a weight
moves by about lr x sign(g) there, and a sign the sums' order decides may
move it the other way, by at most 2 lr).  The reference's own test holds
its sharded step at 1e-2 / 5e-2.  At mesh (1, 1) the step is the
``mesh=None`` step bit for bit, and the MoE routing (choices, slots,
drops) of the mesh's forward is the one-device routing, bit for bit.
Each rank's collective bytes by op, turned into ring bytes
(`roofline.analysis.counted_collectives`), equal the dry run's closed
form (`roofline.analysis.lm_collectives`) for the same cell; Adafactor's
own sums are not in the closed form and its case is held to the loss and
parameters alone.
"""
import concurrent.futures
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as RANK_CASES
from repro import configs as JC
from repro.models import lm as JLM
from repro.training import optimizer as JO
from repro.training import train_lib as JT
from repro_torch import configs as TC
from repro_torch.io import convert
from repro_torch.launch import dist as LD
from repro_torch.launch import train as TTR
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TMOE
from repro_torch.roofline import analysis as RA
from repro_torch.training import optimizer as TO
from repro_torch.training import train_lib as TT

AXES = ("data", "model")
B, S = 4, 16
STEP = 50                    # past AdamW's warmup: the step moves weights
SGD = dict(name="sgd", lr=0.1, grad_clip=0.0, warmup_steps=0)
ADAMW = dict(name="adamw")
# name: (arch, config overrides, mesh shape, optimizer, step)
CASES = {
    "gemma_2x2_reference": ("gemma-7b", {}, (2, 2), SGD, 0),
    "gemma_1x2_reference": ("gemma-7b", {}, (1, 2), SGD, 0),
    "danube_gqa_kv2": ("h2o-danube-3-4b", {"n_kv_heads": 2}, (2, 2), ADAMW,
                       STEP),
    "danube_mqa_kv1": ("h2o-danube-3-4b", {"n_kv_heads": 1}, (2, 2), ADAMW,
                       STEP),
    "phi_moe_ep": ("phi3.5-moe-42b-a6.6b", {}, (2, 2), ADAMW, STEP),
    "grok_moe_tp": ("grok-1-314b", {}, (2, 2), ADAMW, STEP),
    "mamba2_ssm": ("mamba2-370m", {}, (2, 2), ADAMW, STEP),
    "zamba2_hybrid": ("zamba2-1.2b", {}, (2, 2), ADAMW, STEP),
    "vision_vlm": ("llama-3.2-vision-11b", {}, (2, 2), ADAMW, STEP),
    "musicgen_audio": ("musicgen-medium", {}, (2, 2), ADAMW, STEP),
    "gemma_dp_only": ("gemma-7b", {"tp_strategy": "dp_only"}, (2, 2),
                      ADAMW, STEP),
    "gemma_adafactor_factored": ("gemma-7b", {}, (2, 2),
                                 dict(name="adafactor", factored_min_dim=64),
                                 STEP),
    "gemma_adafactor_whole": ("gemma-7b", {}, (2, 2),
                              dict(name="adafactor"), STEP),
    "danube_2_microbatches_remat": ("h2o-danube-3-4b",
                                    {"microbatches": 2, "remat": True},
                                    (2, 2), ADAMW, STEP),
    "gemma_1x1": ("gemma-7b", {}, (1, 1), ADAMW, STEP),
}
REFERENCE = ("gemma_2x2_reference", "gemma_1x2_reference")
MOE = ("phi_moe_ep", "grok_moe_tp")
ADAFACTOR = ("gemma_adafactor_factored", "gemma_adafactor_whole")
LAUNCH = ["--arch", "h2o-danube-3-4b", "--mesh", "--model-parallel", "2",
          "--steps", "5", "--batch", "4", "--seq", "16", "--save-every", "2",
          "--log-every", "1"]


def _cfg(name):
    arch, over, _, _, _ = CASES[name]
    return dataclasses.replace(TC.smoke_config(arch), dtype="float32",
                               **over)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        inputs = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"inputs": inputs,
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(name):
    """The case's whole parameters: the reference's (carried over) for the
    reference cases, else the port's from seed 0; the VLM's cross gates
    drawn nonzero, so that the cross blocks are seen."""
    cfg = _cfg(name)
    if name in REFERENCE:
        jcfg = dataclasses.replace(JC.smoke_config(CASES[name][0]),
                                   dtype="float32")
        return convert.lm_params_from_arrays(
            cfg, _np(JLM.init(jcfg, jax.random.key(0))), device="cpu")
    p = TLM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for site in p.get("cross", []):
        site["gate"] = torch.from_numpy(np.random.default_rng(11).normal(
            size=tuple(site["gate"].shape)).astype(np.float32))
    return p


def _payload(tmp):
    arrays, cases = {}, []
    for name, (arch, over, shape, opt, step) in CASES.items():
        cfg = _cfg(name)
        arrays[f"{name}/params"] = _params(name)
        keys = {}
        for k, v in _batch(cfg).items():
            arrays[f"{name}/{k}"] = v
            keys[k] = f"{name}/{k}"
        cases.append(dict(name=name, kind="lm", mesh=(shape, AXES),
                          arch=arch, cfg=dict(over, dtype="float32"),
                          opt=opt, batch=keys, params=f"{name}/params",
                          grads=True, plans=name in MOE, step=step))
    cases.append(dict(name="launch", kind="train_cli", mesh=((2, 2), AXES),
                      argv=LAUNCH, dir=str(tmp)))
    return dict(arrays=arrays, cases=cases)


def _one_device(name, arrays):
    """The port's ``mesh=None`` gradients and step from the same
    parameters: (loss, grads, params after, MoE plans of the gradient's
    forward)."""
    cfg = _cfg(name)
    ocfg = TO.OptConfig(**CASES[name][3])
    p = TO.tree_map(lambda t: t.clone(), arrays[f"{name}/params"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    plans, plan = [], TMOE.moe_plan

    def recording(*a, **kw):
        res = plan(*a, **kw)
        plans.append({k: res[k].numpy() for k in ("gidx", "slot",
                                                   "in_cap")})
        return res
    TMOE.moe_plan = recording
    try:
        loss, grads = TT.make_grad_fn(cfg)(p, batch)
    finally:
        TMOE.moe_plan = plan
    st = TO.opt_init(p, ocfg)
    p, st, m = TT.make_train_step(cfg, TT.TrainConfig(opt=ocfg))(
        p, st, batch, CASES[name][4])
    return (float(m["loss"]), TO.tree_map(lambda t: t.detach(), grads),
            TO.tree_map(lambda t: t.detach(), p), plans)


def _reference(name):
    """The reference's unsharded step (its own test's case)."""
    jcfg = dataclasses.replace(JC.smoke_config(CASES[name][0]),
                               dtype="float32")
    tcfg = JT.TrainConfig(opt=JO.OptConfig(**SGD))
    params = JLM.init(jcfg, jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(_cfg(name)).items()}
    step = JT.jit_train_step(jcfg, tcfg, None, donate=False)
    p, _, m = step(params, JO.opt_init(params, tcfg.opt), batch,
                   jnp.int32(0))
    return float(m["loss"]), _np(p)


@pytest.fixture(scope="module")
def runs():
    """(rank results, one-device results, reference results).  The
    one-device steps run on one thread: at these sizes more threads only
    contend with the world's ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _runs()
    finally:
        torch.set_num_threads(threads)


def _runs():
    with tempfile.TemporaryDirectory() as tmp:
        payload = _payload(tmp)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(LD.spawn, RANK_CASES.FN, 4, f"{tmp}/world",
                              backend="gloo", device="cpu", payload=payload,
                              timeout=600, pythonpath=[RANK_CASES.HERE])
            ref = {n: _reference(n) for n in REFERENCE}
            one = {n: _one_device(n, payload["arrays"]) for n in CASES}
            ranks = fut.result()
    return ranks, one, ref


def _leaf_share(want, got, tol=1e-4):
    """The largest error of any leaf over ``tol`` x its largest
    magnitude."""
    worst = 0.0
    for a, b in zip(TO.tree_leaves(want), TO.tree_leaves(got)):
        a = torch.as_tensor(np.asarray(a, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        assert a.shape == b.shape
        env = tol * max(float(a.abs().max()), 1e-30)
        worst = max(worst, float((a - b).abs().max()) / env)
    return worst


def _resolved_share(grads, want, got, lr, tol=1e-4):
    """Parameters after AdamW: where |g| > tol x max|g| the error over tol
    x max|p|; elsewhere over 2 lr + tol x max|p|."""
    worst = 0.0
    for g, a, b in zip(*(TO.tree_leaves(t) for t in (grads, want, got))):
        g = torch.as_tensor(np.asarray(g, np.float32))
        a = torch.as_tensor(np.asarray(a, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        env = tol * max(float(a.abs().max()), 1e-30)
        ok = g.abs() > tol * float(g.abs().max())
        d = (a - b).abs()
        if bool(ok.any()):
            worst = max(worst, float(d[ok].max()) / env)
        if bool((~ok).any()):
            worst = max(worst, float(d[~ok].max()) / (2 * lr + env))
    return worst


@pytest.mark.parametrize("name", [n for n in CASES if n != "gemma_1x1"])
def test_mesh_step_matches_one_device(runs, name):
    """Loss, gradients and the parameters after one step against the
    port's one-device step."""
    ranks, one, _ = runs
    got = ranks[0][name]
    loss, grads, params, _ = one[name]
    assert abs(got["grad_loss"] - loss) <= 1e-5 * abs(loss)
    assert abs(got["losses"][0] - loss) <= 1e-5 * abs(loss)
    assert _leaf_share(grads, got["grads"]) <= 1.0
    ocfg = TO.OptConfig(**CASES[name][3])
    if ocfg.name == "sgd":
        assert _leaf_share(params, got["params"]) <= 1.0
    else:
        lr = float(TO.lr_schedule(ocfg, CASES[name][4]))
        assert _resolved_share(grads, params, got["params"], lr) <= 1.0


@pytest.mark.parametrize("name", REFERENCE)
def test_mesh_step_matches_the_reference_unsharded_step(runs, name):
    """gemma-7b's smoke config on (2, 2) and (1, 2), as the reference's
    ``test_sharded_lm_train_step_matches_unsharded``, held to the
    reference's unsharded step: the loss within 1e-5 relative and the
    parameters after one SGD step within 1e-4 of their largest."""
    ranks, _, ref = runs
    got = ranks[0][name]
    loss, want = ref[name]
    assert abs(got["losses"][0] - loss) <= 1e-5 * abs(loss)
    port = convert.lm_tree_to_arrays(
        TO.tree_map(torch.from_numpy, got["params"]))
    assert _leaf_share(jax.tree.leaves(want), jax.tree.leaves(port)) <= 1.0


def test_one_rank_mesh_is_the_one_device_step_bitwise(runs):
    ranks, one, _ = runs
    got = ranks[0]["gemma_1x1"]
    loss, grads, params, _ = one["gemma_1x1"]
    assert got["losses"][0] == loss and got["grad_loss"] == loss
    for a, b in zip(TO.tree_leaves(grads), TO.tree_leaves(got["grads"])):
        assert np.array_equal(a.numpy(), b)
    for a, b in zip(TO.tree_leaves(params), TO.tree_leaves(got["params"])):
        assert np.array_equal(a.numpy(), b)
    assert all(r["gemma_1x1"] is None for r in ranks[1:])
    assert got["by_op"] == {}


@pytest.mark.parametrize("name", MOE)
def test_moe_routing_is_the_one_device_routing(runs, name):
    """Every MoE layer's choices, slots and drops on the mesh (each rank
    routes its data shard's tokens) are the one-device ones on the same
    rows, bit for bit."""
    ranks, one, _ = runs
    plans = one[name][3]
    got = ranks[0][name]["plans"]
    assert got and len(got) == len(plans)
    # Mesh rank 0 routes the data shard's first B / 2 rows: the
    # one-device run's first groups of the same size.
    for g, w in zip(got, plans):
        assert g["gidx"].shape[1:] == w["gidx"].shape[1:]
        for k in ("gidx", "slot", "in_cap"):
            assert np.array_equal(g[k], w[k][:g[k].shape[0]]), k


@pytest.mark.parametrize("name", [n for n in CASES if n not in ADAFACTOR])
def test_counted_collective_bytes_are_the_closed_form(runs, name):
    """Each rank's first step, its collectives by op as ring bytes, equals
    `lm_collectives` for the cell (global batch B, S tokens)."""
    ranks, _, _ = runs
    shape = CASES[name][2]
    sizes = dict(zip(AXES, shape))
    want = RA.lm_collectives(_cfg(name), "train", S, B,
                             AbstractMesh(shape, AXES))
    got = [r[name] for r in ranks if r[name] is not None]
    assert len(got) == np.prod(shape)
    for g in got:
        stats = RA.counted_collectives(g["by_op"], g["calls"], sizes)
        assert stats.bytes_by_op == want.bytes_by_op
        assert stats.count_by_op == want.count_by_op


def test_launch_mesh_killed_and_resumed_is_bitwise(runs):
    """`launch.train --mesh --model-parallel 2` on the 4-rank world: killed
    at step 3 of 5 (checkpoints every 2: rank 0 writes the gathered state)
    and resumed, it ends on every rank's blocks where an unbroken run
    ends."""
    ranks, _, _ = runs
    for r in ranks:
        got = r["launch"]
        assert got["shape"] == (2, 2) and got["killed"] and got["same"]
        assert got["steps"] == (5, 5)
        assert [x["step"] for x in got["resumed_logs"]] == [2, 3, 4]
        for a, b in zip(got["resumed_logs"], got["whole_logs"][2:]):
            assert a["loss"] == b["loss"]


def test_compress_for_an_lm_has_nothing_to_port():
    """The reference's LM step reads neither ``compress_pods`` nor
    ``compress_rank`` (ROADMAP §C): ``--compress`` for an LM is refused,
    naming the GBDT's ``--dist`` fit, where it applies."""
    assert {f.name for f in dataclasses.fields(JT.TrainConfig)} >= {
        "compress_pods", "compress_rank"}
    with pytest.raises(NotImplementedError, match="nothing to port"):
        TTR.train_lm(TTR.parser().parse_args(
            ["--arch", "gemma-7b", "--compress", "--device", "cpu"]))
