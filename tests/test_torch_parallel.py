"""PyTorch port vs the JAX package: data, tensor and FSDP parallelism.

The spec functions (``parallel/sharding.py``) against JAX's, leaf by leaf
through the ``from_flax`` name map.  Then one process group of four ranks
(gloo, on the CPU; ``_torch_parallel_worker.py``), spawned once for the
module: on a 2 x 2 and a 4 x 1 (data, model) mesh, for ``basic``,
``autoformer`` and ``conv_attn``, with and without FSDP, one step's loss and
gradients (gathered whole) against JAX's single-device ``jax.grad`` at the
JAX package's tests/test_parallel.py tolerances, the delays against the
single-device port's, a two-step epoch against the single-device port's
trainer, every rank's weights equal, FSDP storage sharded; and
``cli.main`` with ``--dp 2 --tp 2`` (and ``--fsdp True``), whose checkpoint
a single-process ``InferenceSession.from_checkpoint`` loads.  None of these
configurations draws at random in training (GP blur, no hidden GP layer),
so both frameworks see the same function.
"""

import os
import socket

import jax
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import _torch_parallel_worker as worker
from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_tpu.parallel import (
    mesh as jmesh,
    sharding as jsharding,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    schedule as jschedule,
)
from fine_grained_gaussian_process_forcasting_torch import parallel
from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (
    make_synthetic_frame,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    opt_state_from_optax,
)
from fine_grained_gaussian_process_forcasting_torch.train.harness import (
    ExperimentHarness,
    HarnessArgs,
)
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

# the JAX package's tests/test_parallel.py tolerances
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
# the sharded port against the single-device port, the same arithmetic
# summed in another order, after two Adam steps: Adam divides each
# gradient by its own root mean square, so an element whose gradient is
# near its rounding moves by a share of the learning rate; the weights are
# held to the gradients' tolerance and the epoch's loss to the loss's
RANK_TIMEOUT_S = 300


def _jax_params(attn):
    """JAX's model on the plain references of its Pallas kernels, the fused
    GP's and the head-folded attention's (in interpret mode the kernels
    compute the same functions and take ten times as long to trace), and
    its initial parameters with the ELBO made to count (lam inside its
    clip, q(u) away from the prior), as numpy."""
    model = jfd.ForecastDenoising(**worker.CFG, attn_type=attn,
                                  use_fused_gp=False,
                                  use_pallas_attention=False)
    enc, dec, y = (a[0] for a in worker.batches())
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda e, d, t: model.init(
        {"params": key, "noise": key, "sampling": key}, e, d, t,
        training=True))(enc, dec, y)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lam"] = np.array([0.003], np.float32)
    rng = np.random.default_rng(5)
    layer = params["deep_gp"]["output_layer"]
    for name, scale in (("variational_mean", 0.5),
                        ("variational_log_stddev", 0.3)):
        layer[name] = (scale * rng.normal(size=layer[name].shape)).astype(
            np.float32)
    return model, params


def _jax_loss_and_grads(model, params):
    enc, dec, y = (a[0] for a in worker.batches())

    def loss(p):
        return model.apply({"params": p}, enc, dec, y, training=True,
                           rngs={"noise": jax.random.PRNGKey(1),
                                 "sampling": jax.random.PRNGKey(2)}).loss

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_models():
    return {attn: _jax_params(attn) for attn in worker.ATTNS}


@pytest.fixture(scope="module")
def ranks(jax_models, tmp_path_factory):
    """Every rank's results, and the single-device references: the
    port's (same inputs) and JAX's."""
    workdir = str(tmp_path_factory.mktemp("ranks"))
    torch.save({"params": {a: from_flax(p) for a, (_, p) in
                           jax_models.items()}},
               os.path.join(workdir, "inputs.pt"))
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run, args=(r, port, workdir))
             for r in range(worker.WORLD)]
    for p in procs:
        p.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside the four ranks' one thread each
    try:  # the references while the ranks run
        single = {a: worker.step_and_epoch(a, from_flax(p),
                                           worker.batches())[2]
                  for a, (_, p) in jax_models.items()}
        single.update({o: worker.step_and_epoch(o, None, worker.batches(
            dec_len=kw.get("dec_len", worker.DEC_LEN)))[2]
            for o, kw in worker.OPTIONS.items()})
        reference = {a: _jax_loss_and_grads(*jax_models[a])
                     for a in worker.ATTNS}
        for p in procs:
            p.join(RANK_TIMEOUT_S)
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    assert [p.exitcode for p in procs] == [0] * worker.WORLD
    results = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                          weights_only=False) for r in range(worker.WORLD)]
    return {"ranks": results, "single": single, "jax": reference,
            "workdir": workdir}


def _names(params):
    """{port name: JAX path} through from_flax's name map."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for path, leaf in flat:
        keys = [k.key for k in path]
        leaf_name = "weight" if keys[-1] == "kernel" else keys[-1]
        out[".".join(keys[:-1] + [leaf_name])] = "/".join(keys)
    return out


def _jax_specs(specs):
    return {"/".join(getattr(k, "key", str(k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _turned(spec, ndim, path):
    """JAX's spec over the port's axes: from_flax reverses a kernel's."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    if path.endswith("/kernel"):
        spec = (spec + (None,) * (ndim - len(spec)))[::-1]
        while spec and spec[-1] is None:
            spec = spec[:-1]
    return spec


def _port_shapes(params):
    return {k: tuple(v.shape) for k, v in from_flax(params).items()}


# -- the spec functions ------------------------------------------------ #

@pytest.mark.parametrize("attn", worker.ATTNS)
def test_param_specs_match_jax(jax_models, attn):
    _, params = jax_models[attn]
    shapes, names = _port_shapes(params), _names(params)
    want = _jax_specs(jsharding.param_specs(params))
    got = parallel.param_specs(shapes)
    assert set(got) == set(names)
    for name, spec in got.items():
        path = names[name]
        assert spec == _turned(want[path], len(shapes[name]), path), name
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("n_model", [2, 1])
@pytest.mark.parametrize("attn", worker.ATTNS)
def test_fsdp_specs_match_jax(jax_models, attn, n_model):
    _, params = jax_models[attn]
    shapes, names = _port_shapes(params), _names(params)
    want = _jax_specs(jsharding.fsdp_specs(params, n_data=4,
                                           n_model=n_model))
    got = parallel.fsdp_specs(shapes, n_data=4, n_model=n_model)
    for name, spec in got.items():
        path = names[name]
        assert spec == _turned(want[path], len(shapes[name]), path), name
    assert any("data" in s for s in got.values())


@pytest.mark.parametrize("fsdp", [False, True])
def test_opt_state_shardings_match_jax(jax_models, fsdp):
    _, params = jax_models["basic"]
    jmesh_ = jmesh.make_mesh(n_data=4, n_model=2)
    jstate = optax.adam(1e-3).init(params)
    want = jsharding.opt_state_shardings(jmesh_, jstate, params, fsdp=fsdp)
    model = worker.make_model("basic")
    model.load_state_dict(from_flax(params))
    named = dict(model.named_parameters())
    opt = torch.optim.Adam(model.parameters())
    got = parallel.opt_state_shardings({"data": 4, "model": 2},
                                       opt.state_dict(), named, fsdp=fsdp)
    # which JAX moment becomes the port's state i: the converter's own map
    # (opt_state_from_optax) on moments that hold their leaf's index
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    paths = ["/".join(k.key for k in path) for path, _ in flat]
    tags = jax.tree_util.tree_unflatten(tree, [
        np.full(np.shape(leaf), j, np.float32)
        for j, (_, leaf) in enumerate(flat)])
    adam, schedule = jschedule.noam_adam(8).init(tags)
    port = opt_state_from_optax((adam._replace(mu=tags, nu=tags), schedule),
                                list(named))
    mu, nu = (_jax_specs(jax.tree_util.tree_map(
        lambda s: s.spec, getattr(want[0], k),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
        for k in ("mu", "nu"))
    for i, name in enumerate(named):
        path = paths[int(port["state"][i]["exp_avg"].flatten()[0])]
        ndim = named[name].ndim
        assert got["state"][i]["exp_avg"] == _turned(mu[path], ndim, path)
        assert got["state"][i]["exp_avg_sq"] == _turned(nu[path], ndim, path)
        assert got["state"][i]["step"] == ()
    assert tuple(want[0].count.spec) == ()


def test_make_mesh_raises_on_short_world(ranks):
    """In a group of 4, a 4 x 2 mesh is refused with JAX's wording and the
    launch to use; outside torchrun make_mesh says how to start one."""
    for res in ranks["ranks"]:
        assert "make_mesh(n_data=4, n_model=2) needs 8 devices" in res[
            "short_world"]
        assert "torchrun" in res["short_world"]
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.make_mesh(2, 1, device="cpu")


# -- sharded steps ------------------------------------------------------ #

# a gradient that is 0 in exact arithmetic (ATA's convolution biases under
# their batch norms; fedformer's query bias, whose constant reaches only
# the zero mode, which no block keeps) is rounding residue on both sides,
# below ZERO_GRAD of the step's largest gradient: Adam divides it by its
# own size and moves such a leaf by a share of the learning rate either
# way, so its weights are not compared after the updates
ZERO_GRAD = 1e-5


def _moved(single):
    """The leaves whose single-device gradient is more than residue."""
    largest = max(float(g.abs().max()) for g in single["grads"].values())
    return [k for k, g in single["grads"].items()
            if float(g.abs().max()) > ZERO_GRAD * largest]


CASE_IDS = [worker.case_key(*c) for c in worker.CASES]


@pytest.mark.parametrize("case", worker.CASES, ids=CASE_IDS)
def test_sharded_step_matches_jax(ranks, case):
    _, attn, _ = case
    key = worker.case_key(*case)
    want_loss, want_grads = ranks["jax"][attn]
    for res in ranks["ranks"]:  # the global loss on every rank
        np.testing.assert_allclose(res["cases"][key]["loss"], want_loss,
                                   **LOSS_TOL)
    got = to_flax(ranks["ranks"][0]["cases"][key]["grads"])
    flat_want = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    for path, want in flat_want:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, want, **GRAD_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("case", worker.CASES, ids=CASE_IDS)
def test_sharded_epoch_matches_single_device(ranks, case):
    """Two updates on the mesh equal the single-device trainer's, and every
    rank ends them with the same weights."""
    _, attn, _ = case
    key = worker.case_key(*case)
    single = ranks["single"][attn]
    res = [r["cases"][key] for r in ranks["ranks"]]
    np.testing.assert_allclose(res[0]["epoch_loss"], single["epoch_loss"],
                               **LOSS_TOL)
    for name, want in single["full"].items():
        torch.testing.assert_close(res[0]["full"][name], want, **GRAD_TOL)
    assert len({r["full_digest"] for r in res}) == 1
    assert all(r["replicated_ok"] for r in res)


@pytest.mark.parametrize("case", worker.OPTION_CASES,
                         ids=[worker.option_key(*c) for c in
                              worker.OPTION_CASES])
def test_sharded_options_match_single_device(ranks, case):
    """The rest of the zoo and the LSTM backbone on the 2 x 2 mesh (ATA,
    ACAT: heads gathered for their convolutions, statistics over the
    global batch; informer: the rank's heads, the global key samples;
    fedformer: replicated but its row-parallel fc; lstm: data only): one
    step's loss and gradients, and two updates, equal the single-device
    port's."""
    option, _ = case
    key = worker.option_key(*case)
    single = ranks["single"][option]
    res = [r["cases"][key] for r in ranks["ranks"]]
    for r in res:
        np.testing.assert_allclose(r["loss"], single["loss"], **LOSS_TOL)
    for name, want in single["grads"].items():
        torch.testing.assert_close(res[0]["grads"][name], want, **GRAD_TOL)
    np.testing.assert_allclose(res[0]["epoch_loss"], single["epoch_loss"],
                               **LOSS_TOL)
    # ATA's top-1 over its scales and ReLU put a share of its convolution
    # weights' gradient elements near 0, which Adam's per-element scaling
    # turns into moves of a share of the learning rate: its step-1
    # gradients are compared, not its weights after the updates
    for name in (_moved(single) if option != "ATA" else ()):
        torch.testing.assert_close(res[0]["full"][name],
                                   single["full"][name], **GRAD_TOL)
    assert len({r["full_digest"] for r in res}) == 1


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_sharded_autoformer_delays_match_single_device(ranks, mesh):
    key = worker.case_key(mesh, "autoformer", False)
    want = ranks["single"]["autoformer"]["delays"]
    assert want  # one call per self- and cross-attention a pass
    for res in ranks["ranks"]:
        for fsdp in (False, True):
            assert res["cases"][worker.case_key(
                mesh, "autoformer", fsdp)]["delays"] == want, key


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_fsdp_storage_is_sharded(ranks, mesh):
    """As JAX's addressable shards: each leaf the FSDP rule shards, and its
    Adam moments, hold at most half their elements on a rank."""
    n_data = worker.MESHES[mesh][0]
    for attn in worker.ATTNS:
        for res in ranks["ranks"]:
            storage = res["cases"][worker.case_key(mesh, attn, True)][
                "storage"]
            assert storage
            for name, (param, mu, nu, whole) in storage.items():
                assert param == mu == nu, name
                assert param * 2 <= whole, name
                assert param * n_data <= whole, name


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_mesh_checkpoint_round_trip(ranks, mesh):
    """save_state writes one whole checkpoint, a single device's shapes,
    and restore_state puts it back on the mesh bit for bit, parameters
    and Adam moments, on every rank."""
    for attn in worker.ATTNS:
        key = worker.case_key(mesh, attn, True)
        want = {k: tuple(v.shape) for k, v in
                worker.make_model(attn).state_dict().items()}
        for res in ranks["ranks"]:
            trip = res["cases"][key]["round_trip"]
            assert trip["params"] and trip["moments"], key
            assert trip["whole"] == want, key


@pytest.mark.parametrize("run", list(worker.CLI_RUNS))
def test_cli_mesh_trains_and_evaluates(ranks, run):
    """--dp 2 --tp 2 (and --fsdp True) through cli.main: a finite test MSE,
    the same on every rank."""
    mses = [res["cli"][run] for res in ranks["ranks"]]
    assert len(mses[0]) == 1 and np.isfinite(mses[0][0])
    assert all(m == mses[0] for m in mses)


@pytest.mark.parametrize("run", list(worker.CLI_RUNS))
def test_cli_mesh_checkpoint_loads_in_one_process(ranks, run, tmp_path):
    """Rank 0 wrote one whole checkpoint, a single device's: a
    single-process session of the harness's model takes it unchanged and
    serves finite forecasts of the test windows."""
    models = os.path.join(ranks["workdir"], f"cli_{run}", "models_solar_8")
    (name,) = os.listdir(models)
    harness = ExperimentHarness(
        make_synthetic_frame("solar", num_entities=8, steps_per_entity=1600,
                             seed=0),
        HarnessArgs(exp_name="solar", attn_type="basic", pred_len=8,
                    num_inducing=8, max_train_samples=64,
                    max_valid_samples=64, out_dir=str(tmp_path)),
        device="cpu")
    model = harness._make_model(16, 1)
    session = InferenceSession.from_checkpoint(
        model, models, name, template_params=model.state_dict(),
        batch_size=4, device="cpu")
    enc, dec = harness.test_data.enc[0][:4], harness.test_data.dec[0][:4]
    assert np.isfinite(np.asarray(session.predict(enc, dec))).all()
