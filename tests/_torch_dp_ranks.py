"""What the data-parallel tests run on each rank (imports torch and
`interdiff_torch` only, so that a spawned rank starts quickly and without
JAX): the train cases of `test_torch_data_parallel_train.py` and the
collectives and samplers of `test_torch_parallel.py`.  Each function takes
numpy inputs and returns numpy results, so that both cross the process
boundary; `run_case` also runs in the test's own process on a mesh of one
rank."""

from __future__ import annotations

import numpy as np
import torch

from interdiff_torch.config import SmplTrackConfig
from interdiff_torch.diffusion.resample import LossSecondMomentResampler
from interdiff_torch.models import correction as tcorr
from interdiff_torch.parallel import mesh as pmesh
from interdiff_torch.train import trainer as ttr

LR = 3e-4
SHADOWED = ("res_conv.bias", "tcn_conv.bias")


def _numpy(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _metrics_rows(metrics, k=None):
    if k is None:
        return [{n: float(v) for n, v in metrics.items()}]
    return [{n: float(v[i]) for n, v in metrics.items()} for i in range(k)]


def _smpl_case(case, mesh):
    track = SmplTrackConfig(**case["track"])
    model = track.build_model("cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["init"].items()}, strict=True)
    diffusion = track.diffusion.build("cpu")
    sampler, sampler_state = "uniform", None
    if case.get("loss_aware"):
        sampler = LossSecondMomentResampler(diffusion.num_timesteps,
                                            history_per_term=2)
        sampler_state = sampler.init_state()
    bn = bool(case.get("bn_train_mode"))
    if bn:
        params, model_state = ttr.split_bn_state(model)
    else:
        params, model_state = dict(model.named_parameters()), None
    state = ttr.TrainState.create(
        params, ttr.adamw(LR), sampler_state=sampler_state,
        ema_rate=case.get("ema_rate", 0.0), model_state=model_state)
    step = ttr.make_smpl_train_step(model, diffusion,
                                    schedule_sampler=sampler,
                                    bn_train_mode=bn)
    ts = torch.from_numpy(case["t"]).long()
    noise = torch.from_numpy(case["noise"])
    if case.get("chain"):
        step = ttr.data_parallel_step(ttr.chain_steps(step), mesh,
                                      batch_axis=1)
        stacked = {k: np.stack([b[k] for b in case["batches"]])
                   for k in case["batches"][0]}
        state, m = step(state, step.place_batch(stacked),
                        t=pmesh.shard_batch(ts, mesh, axis=1),
                        noise=pmesh.shard_batch(noise, mesh, axis=1))
        rows = _metrics_rows(m, len(case["batches"]))
    else:
        step = ttr.data_parallel_step(step, mesh)
        rows = []
        for i, b in enumerate(case["batches"]):
            state, m = step(state, step.place_batch(b),
                            t=pmesh.shard_batch(ts[i], mesh),
                            noise=pmesh.shard_batch(noise[i], mesh))
            rows += _metrics_rows(m)
    out = {"metrics": rows, "weights": _numpy(model.state_dict()),
           "step": state.step}
    if state.ema_params is not None:
        out["ema"] = _numpy(ttr.merge_bn_state(state.ema_params,
                                               state.model_state))
    if sampler_state is not None:
        out["sampler"] = (state.sampler_state.loss_counts.numpy().copy(),
                          state.sampler_state.loss_history.numpy().copy())
    return out


def _sync_shadowed(proj, want):
    """The biases a train-mode BatchNorm subtracts again have an exactly
    zero gradient, so each package steps rounding noise: check how far
    they went (and that the gradient is noise), then take JAX's values."""
    grads = {n: p.grad for n, p in proj.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads.values())
    dev, noise = 0.0, 0.0
    with torch.no_grad():
        for name, p in proj.named_parameters():
            if name.endswith(SHADOWED):
                noise = max(noise, float(grads[name].abs().max()) / largest)
                dev = max(dev, float((p - torch.from_numpy(
                    want[name])).abs().max()))
                p.copy_(torch.from_numpy(want[name]))
    return dev, noise


def _correction_case(case, mesh):
    smpl = case["kind"] == "correction_smpl"
    cls = tcorr.ObjProjectorSmpl if smpl else tcorr.ObjProjectorSkeleton
    proj = cls(**case["kw"], device="cpu")
    proj.load_state_dict({k: torch.from_numpy(v)
                          for k, v in case["init"].items()}, strict=True)
    state = ttr.CorrectionTrainState.create(proj, ttr.adam(LR))
    make = ttr.make_correction_smpl_train_step if smpl \
        else ttr.make_correction_skeleton_train_step
    step = ttr.data_parallel_step(make(proj), mesh, extra_args=2)
    # the draws of dropout, when the case has it, from a seeded generator
    generator = torch.Generator().manual_seed(case["seed"]) \
        if "seed" in case else None
    rows, devs, noises = [], [], []
    for i, b in enumerate(case["batches"]):
        kw = {}
        if smpl:
            kw["marker_idx"] = pmesh.shard_batch(
                torch.from_numpy(case["marker_idx"][i]), mesh)
        state, m = step(state, step.place_batch(b), generator,
                        float(case["epochs"][i]), **kw)
        rows += _metrics_rows(m)
        dev, noise = _sync_shadowed(proj, case["shadow"][i])
        devs.append(dev)
        noises.append(noise)
    return {"metrics": rows, "weights": _numpy(proj.state_dict()),
            "shadow_dev": max(devs), "shadow_grad": max(noises),
            "step": state.step}


def run_case(case, mesh):
    """One train case (see `test_torch_data_parallel_train.py`) on
    ``mesh``: its metrics per step and the final weights."""
    if case["kind"] == "smpl":
        return _smpl_case(case, mesh)
    return _correction_case(case, mesh)


def train_cases(payload):
    """Every case on this rank's mesh, then the ``local`` ones again with
    the BatchNorm all-reduce taken out (each rank's own statistics): the
    copy the tests must tell apart."""
    from interdiff_torch.models import layers

    mesh = pmesh.make_mesh(device="cpu")
    out = {name: run_case(case, mesh)
           for name, case in payload["cases"].items()}
    real = layers.all_reduce_sum
    layers.all_reduce_sum = lambda x, mesh: x
    try:
        for name in payload["local"]:
            out["local_" + name] = run_case(payload["cases"][name], mesh)
    finally:
        layers.all_reduce_sum = real
    return out


# ---------------------------------------------------------------------------
# collectives and samplers (`test_torch_parallel.py`)
# ---------------------------------------------------------------------------

def _tiny_sampler(payload, device="cpu"):
    from interdiff_torch.diffusion.gaussian import GaussianDiffusion
    from interdiff_torch.utils.fixtures import make_tiny_correction_sampler

    model = SmplTrackConfig(**payload["track"]).build_model(device)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in payload["mdm"].items()}, strict=True)
    diffusion = GaussianDiffusion.create_named(
        steps=payload["steps"], timestep_respacing=payload["respacing"],
        device=device)
    gt = torch.from_numpy(payload["gt"]).to(device)
    return make_tiny_correction_sampler(
        model, diffusion, gt, projector_state={
            k: torch.from_numpy(v) for k, v in payload["projector"].items()})


def sample_world(payload, mesh):
    """The tiny correction sampler through `data_parallel_sample` on
    ``mesh``: with the given noise (every rank's rows gathered), and with
    noise drawn from a generator seeded alike on every rank."""
    from interdiff_torch.parallel.sample_parallel import data_parallel_sample

    sampler = _tiny_sampler(payload)
    args = [torch.from_numpy(payload[k])
            for k in ("gt", "pts", "hand", "betas")]
    dp = data_parallel_sample(sampler, mesh, out_sharded=False)
    given = dp(*dp.place_batch(args),
               noise=pmesh.shard_batch(torch.from_numpy(payload["noise"]),
                                       mesh),
               step_noise=pmesh.shard_batch(
                   torch.from_numpy(payload["step_noise"]), mesh, axis=1))
    drawn = dp(*dp.place_batch(args),
               generator=torch.Generator().manual_seed(5))
    return {"given": given.numpy(), "drawn": drawn.numpy()}


def collectives(payload):
    """One rank's view of the mesh helpers, sampler included."""
    from interdiff_torch.models import layers
    from interdiff_torch.utils.train_io import quartile_metrics

    mesh = pmesh.make_mesh(device="cpu")
    r = mesh.rank
    out = {"rank": r, "size": mesh.size,
           "rows": pmesh.shard_batch(np.arange(8), mesh)}
    # the differentiable SUM: forward the sum, backward the summed cotangent
    x = torch.tensor([1.0 + r, 2.0], requires_grad=True)
    y = pmesh.all_reduce_sum(x, mesh)
    (y * torch.tensor([3.0 + r, 1.0])).sum().backward()
    out["sum"], out["sum_grad"] = y.detach().numpy(), x.grad.numpy()
    # gather in rank order, metrics mean, quartiles over the global batch
    out["gathered"] = pmesh.all_gather_rows(
        torch.arange(3, dtype=torch.int64) + 10 * r, mesh).numpy()
    out["mean"] = float(pmesh.mean_metrics(
        {"m": torch.tensor(float(r))}, mesh)["m"])
    t = torch.tensor([100, 900]) if r == 0 else torch.tensor([120, 400])
    loss = torch.tensor([1.0, 2.0]) if r == 0 else torch.tensor([3.0, 5.0])
    with pmesh.use_mesh(mesh):
        out["quartiles"] = {k: float(v) for k, v in quartile_metrics(
            t, loss, 1000).items()}
    # the generator's state is rank 0's after a sync
    g = torch.Generator().manual_seed(1 + r)
    pmesh.sync_generator(g, mesh)
    out["after_sync"] = torch.rand(2, generator=g).numpy()
    # draws for the global batch, cut to the rank's rows
    g = torch.Generator().manual_seed(3)
    with pmesh.use_mesh(mesh):
        out["randn_rows"] = pmesh.randn_rows((2, 3), g, "cpu").numpy()
        # dropout: the rank's own stream
        out["dropout"] = layers.dropout(torch.ones(4, 64), 0.5, True,
                                        torch.Generator().manual_seed(3)
                                        ).numpy()
    # replicated: rank 0's values everywhere
    w = torch.full((3,), float(r))
    pmesh.replicated([w], mesh)
    out["replicated"] = w.numpy()
    out["samples"] = sample_world(payload, mesh)
    return out


def fail_on_rank1():
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    mesh = pmesh.make_mesh(device="cpu")
    if mesh.rank == 1:
        raise ValueError("rank 1 stops here")
    mesh.all_reduce_(torch.ones(1))
    return mesh.rank


def late_broadcast(delay):
    """Rank 0 reaches a broadcast ``delay`` seconds after rank 1."""
    import time

    mesh = pmesh.make_mesh(device="cpu")
    if mesh.rank == 0:
        time.sleep(delay)
    mesh.broadcast_(torch.ones(1))
    return mesh.rank


def slow_validation_train(argv, delay):
    """A rank of the skeleton diffusion trainer (`interdiff_torch/cli/
    train_diffusion_skeleton.py::run`) whose validation, which rank 0 runs
    alone, takes ``delay`` seconds longer; returns the rank's summary."""
    import time

    from interdiff_torch.cli import train_diffusion_skeleton as cli

    made = cli.make_validation

    def make_slow(*args, **kwargs):
        validate = made(*args, **kwargs)

        def slow(*vargs, **vkwargs):
            time.sleep(delay)
            return validate(*vargs, **vkwargs)
        return slow

    cli.make_validation = make_slow
    return cli.run(cli.build_parser().parse_args(argv), "cpu")[1]
