"""The denoisers' CUDA graphs (`interdiff_torch/models/denoise_graph.py`).

On the CPU, at small widths on one torch thread: ``denoise`` runs its
eager body bit for bit, with and without a gradient and with
``train=True``, keeps no graph, and in a session counts its calls and no
replay; what re-allocates the parameters drops the graphs, an in-place
``load_state_dict`` keeps them, and a deep copy starts with none.

On the card (marked ``chip``; skipped without one, run there with
``python -m pytest --noconftest tests/test_torch_denoise_graph.py -m
chip``): a 30-step corrected DDPM of each track at full width through
`make_sampler` / `make_skeleton_sampler`, with ``model.denoise`` wrapped
as `bench_port/sampling.py::Recorder` wraps it (references to every
call's input and output, the next call's input as x_{t-1}), equals the
eager run's within 1e-6 relative once the whole loop has finished; then
other weights loaded in place, a second batch size, another precision
and the cache's bound; and a capture while `torch.profiler` records.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from interdiff_torch.config import (  # noqa: E402
    DiffusionConfig,
    SkeletonTrackConfig,
    SmplTrackConfig,
)
from interdiff_torch.models import denoise_graph  # noqa: E402
from interdiff_torch.utils import profiling  # noqa: E402

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
TRACKS = ("smpl", "skeleton")
REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(track: str):
    """A small denoiser of ``track`` on the CPU and one call's inputs."""
    g = torch.Generator().manual_seed(7)
    if track == "smpl":
        model = SmplTrackConfig(**SMALL).build_model("cpu")
        x = torch.randn(2, 35, 144, generator=g)
        return model, (x, torch.tensor([5, 700]),
                       torch.randn(2, 10, 32, generator=g))
    model = SkeletonTrackConfig(**SMALL).build_model("cpu")
    x = torch.randn(2, 20, 106, generator=g)
    return model, (x, torch.tensor([5, 700]),
                   torch.randn(2, 12, 3, generator=g),
                   torch.randn(2, 10, 32, generator=g))


@pytest.mark.parametrize("track", TRACKS)
def test_the_cpu_runs_the_eager_body(track):
    model, inputs = _small(track)
    kept = [t.clone() for t in inputs]
    body = model._denoise(*inputs)
    with torch.no_grad():
        plain = model.denoise(*inputs)
        masked = model.denoise(*inputs, force_mask=True)
    graded = model.denoise(*inputs)
    trained = model.denoise(*inputs, train=True,
                            generator=torch.Generator().manual_seed(1))
    assert graded.requires_grad and not plain.requires_grad
    for out in (plain, graded, trained):
        assert torch.equal(out, body)
    assert torch.equal(masked, model._denoise(*inputs, force_mask=True))
    assert not torch.equal(masked, body)
    assert all(torch.equal(a, b) for a, b in zip(inputs, kept))
    assert not model._graphs


@pytest.mark.parametrize("track", TRACKS)
def test_a_session_counts_calls_and_no_replay(track):
    model, inputs = _small(track)
    with profiling.session() as s:
        with torch.no_grad():
            model.denoise(*inputs)
            model.denoise(*inputs[:-1])  # the null condition
        model.denoise(*inputs, train=True)
    assert s.counters["denoise.calls"] == 3
    assert s.counters.get("denoise.replays", 0) == 0
    assert s.counters.get("denoise.captures", 0) == 0


@pytest.mark.parametrize("track", TRACKS)
def test_reallocating_the_parameters_drops_the_graphs(track):
    model, _ = _small(track)
    model._graphs["planted"] = None
    model.load_state_dict(model.state_dict())  # in place: kept
    assert list(model._graphs) == ["planted"]
    twin = copy.deepcopy(model)
    assert not twin._graphs and list(model._graphs) == ["planted"]
    model.load_state_dict(model.state_dict(), assign=True)
    assert not model._graphs
    model._graphs["planted"] = None
    model.to(torch.float64)
    assert not model._graphs
    model._graphs["planted"] = None
    model.float()
    assert not model._graphs


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda")


class _Keeper:
    """``model.denoise`` wrapped for a sampler call: every call's input and
    output kept by reference; ``eager`` runs the call with a gradient
    recorded, which the graphs never serve."""

    def __init__(self, denoise, eager: bool):
        self.denoise, self.eager, self.calls = denoise, eager, []

    def __call__(self, x, *args, **kwargs):
        if self.eager:
            with torch.enable_grad():
                out = self.denoise(x, *args, **kwargs).detach()
        else:
            out = self.denoise(x, *args, **kwargs)
        self.calls.append((x, out))
        return out

    def triples(self, sample):
        """(x_t, x0, x_{t-1}) of every step, the last one's x_{t-1} the
        sample."""
        nxt = [x for x, _ in self.calls[1:]] + [sample]
        return [(x, out, n) for (x, out), n in zip(self.calls, nxt)]


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _sampler(track: str, device):
    """The track's models at full width on ``device``, a 30-step corrected
    DDPM sampler: (model, ``run()`` the sampler call on fixed noise,
    ``call_inputs(rows)`` the inputs of one denoiser call of ``rows``
    rows)."""
    import chip_smoke as cs

    rng = np.random.default_rng(19)
    diffusion = DiffusionConfig(timestep_respacing="30").build(device)
    if track == "smpl":
        from interdiff_torch.eval.smpl_short import (
            SmplEvalConfig,
            make_sampler,
        )

        model, projector, body = cs.full_width_models(device=device)
        args = cs._main_path_inputs(rng, 4, cs.FRAMES, cs.POINTS, device)
        sample = make_sampler(
            SmplEvalConfig(correction_t_max=9, correction_every=3), model,
            diffusion, smpl=body, projector=projector)
        cond = model.encode(args[0], args[1]).detach()
        shape = args[0].shape
        extra = ()
    else:
        from interdiff_torch.eval.skeleton import (
            SkeletonEvalConfig,
            make_skeleton_sampler,
        )

        model, projector = cs._skeleton_models(device, small=False)
        batch = cs._skeleton_batch(rng, 4)
        args = [torch.from_numpy(batch[k]).to(device) for k in cs.SKEL_KEYS]
        sample = make_skeleton_sampler(
            SkeletonEvalConfig(correction_t_max=9, correction_every=3),
            model, diffusion, projector=projector)
        cond, gt = model.encode(*args)
        cond, shape, extra = cond.detach(), gt.shape, (args[3],)
    noise = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)
    step_noise = torch.from_numpy(rng.standard_normal(
        (30,) + tuple(shape)).astype(np.float32)).to(device)

    def run():
        return sample(*args, noise=noise, step_noise=step_noise)

    def call_inputs(rows: int):
        def randn(*s):
            return torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)).to(device)

        ts = torch.from_numpy(rng.integers(0, 1000, rows)).to(device)
        return ((randn(rows, *shape[1:]), ts)
                + tuple(randn(rows, *e.shape[1:]) for e in extra)
                + (randn(rows, *cond.shape[1:]),))

    return model, run, call_inputs


def _eager(model, inputs, **kwargs):
    with torch.enable_grad():
        return model.denoise(*inputs, **kwargs).detach()


@pytest.mark.chip
@pytest.mark.parametrize("track", TRACKS)
def test_a_graphed_loop_keeps_the_eager_states(track, cuda):
    torch.manual_seed(0)
    model, run, _ = _sampler(track, cuda)
    runs = {}
    for eager in (True, False):
        keeper = _Keeper(model.denoise, eager)
        model.denoise = keeper
        try:
            with profiling.session() as s:
                sample = run()
        finally:
            del model.denoise
        runs[eager] = (keeper.triples(sample), s.counters)
    torch.cuda.synchronize()
    (ref, ref_counts), (got, counts) = runs[True], runs[False]
    assert len(got) == len(ref) == 30
    assert counts["denoise.calls"] == ref_counts["denoise.calls"] == 30
    assert counts["denoise.replays"] == 30 and counts[
        "denoise.captures"] == 1
    assert ref_counts.get("denoise.replays", 0) == 0
    for step, (a, b) in enumerate(zip(got, ref)):
        for name, u, v in zip(("x_t", "x0", "x_{t-1}"), a, b):
            assert _rel(u, v) <= REL, (step, name, _rel(u, v))
    # the outputs of the graphed run are 30 tensors, none shared
    assert len({out.data_ptr() for _, out, _ in got}) == 30


@pytest.mark.chip
@pytest.mark.parametrize("track", TRACKS)
def test_the_cache_follows_weights_batch_precision(track, cuda):
    torch.manual_seed(0)
    model, _, call_inputs = _sampler(track, cuda)
    import chip_smoke as cs

    inputs = call_inputs(8)
    kept = [t.clone() for t in inputs]
    with torch.no_grad():
        first = model.denoise(*inputs)
        first_kept = first.clone()
        assert _rel(first, _eager(model, inputs)) <= REL
        assert all(torch.equal(a, b) for a, b in zip(inputs, kept))

        # other weights, copied in place: the same graph, the new weights
        model.load_state_dict(cs.seeded_state(model, 99), strict=True)
        with profiling.session() as s:
            other = model.denoise(*inputs)
        assert s.counters["denoise.replays"] == 1
        assert s.counters.get("denoise.captures", 0) == 0
        assert _rel(other, _eager(model, inputs)) <= REL
        assert not torch.equal(other, first)
        assert torch.equal(first, first_kept)  # not written by the replay

        # a second batch size, the null condition, the mask, TF32: a graph
        # each; the first one's key replays again without a capture
        half = call_inputs(4)
        variants = [(half, {}), (half[:-1], {}),
                    (half, {"force_mask": True})]
        for args, kw in variants:
            with profiling.session() as s:
                out = model.denoise(*args, **kw)
            assert s.counters["denoise.captures"] == 1
            assert _rel(out, _eager(model, args, **kw)) <= REL
        assert len(model._graphs) == denoise_graph.GRAPHS
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with profiling.session() as s:
                model.denoise(*inputs)
            assert s.counters["denoise.captures"] == 1
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        # the bound held: the oldest, the first batch size, was evicted
        assert len(model._graphs) == denoise_graph.GRAPHS
        with profiling.session() as s:
            again = model.denoise(*inputs)
        assert s.counters["denoise.captures"] == 1
        assert len(model._graphs) == denoise_graph.GRAPHS
        assert torch.equal(again, other)

        # .to() re-allocates: the graphs go, the next call captures
        model.to(cuda)
        model.float()
        assert not model._graphs


@pytest.mark.chip
def test_a_capture_under_the_profiler(cuda):
    model = SmplTrackConfig(**SMALL).build_model(cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    inputs = (torch.randn(4, 35, 144, device=cuda, generator=g),
              torch.randint(0, 1000, (4,), device=cuda, generator=g),
              torch.randn(4, 10, 32, device=cuda, generator=g))
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), profiling.session() as s:
        with torch.profiler.profile(activities=activities):
            first = model.denoise(*inputs)
            second = model.denoise(*inputs)
        third = model.denoise(*inputs)
    assert s.counters["denoise.captures"] == 1
    assert s.counters["denoise.replays"] == 3
    ref = _eager(model, inputs)
    for out in (first, second, third):
        assert _rel(out, ref) <= REL
