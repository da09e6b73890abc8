"""Tensor parallelism of the port (parallel/tensor.py, the 'model' axis of
parallel/mesh.py) over gloo groups on the CPU, against the 1-process port
and the JAX package.

One module fixture writes the inputs (seeded weights as numpy trees in
the JAX package's layout, batches, a policy workspace), starts a group
of 2 worker processes of this file on a ('data', 'model') = 1 x 2 mesh,
then a group of 4 on a 2 x 2 mesh, and meanwhile runs the same
`scenarios` in this process with no mesh, and the JAX package's
generator under its `tp_tree_shardings` jit on 4 CPU devices. Each check
is its own test over the shared results:

  * the split plan against `tp_tree_shardings` on the same parameters
    (G, D, VGG16, an SG3-T G), none on a 1-D mesh, a model axis that
    does not divide the ranks refused;
  * G's forward (1 x 2, 2 x 2) against one process and JAX's TP jit;
  * the walk's loss and w-gradient at step 0 (1 x 2, 2 x 2): the check
    that catches either adjoint of parallel/tensor.py done wrong (an
    all-reduce behind the gather counts the gradient m times; an entry
    without one drops the other ranks' channels);
  * the K-step walk and `forward_ganrand` on 2 x 2;
  * the policy with --n_mesh_devices 4 --n_model_devices 2, the
    ValueError without --n_mesh_devices, the engine's refusal of a mesh
    whose model axis splits nothing;
  * an SG3-T G (K3's plain path) on 1 x 2;
  * each rank holds O/m of every split weight, and gathering the slices
    gives the 1-process module back bit for bit.

Tolerances: the step-0 losses rtol 1e-5, G rtol 1e-5 beside an atol of
1e-5 of its max (near 0: on 2 x 2 each data rank's conv runs at half the
batch, on other algorithms), the step-0 gradient 1e-5 of its max, the K-step walk's images and ws 1e-4 of their max and its
walked w atol 1e-3 (ROADMAP section 3: Adam's first step moves a
coordinate whose gradient is within rounding of 0 by a whole lr either
way, and the image moves with it), the policy's images to the 1-process
G's images of its own walked w; against JAX's TP jit rtol 1e-3 / atol 1e-4,
the JAX package's own bound (tests/test_tensor_parallel.py).

Run as a worker: python tests/test_torch_port_tensor_parallel.py RANK PORT DIR WORLD
"""

import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
M = 2                                   # the model axis
RES, CROP, K, W_DIM = 32, 16, 3, 64
NET = dict(img_resolution=RES, img_channels=2, channel_base=1024, channel_max=64)
B = 8                                   # the walk's batch: on 2 x 2, 2 data ranks x 1 group of 4
NG = 4                                  # G's batch (JAX: divisible by its data axis)
WALK_W = dict(w_lpips=10.0, w_pix=0.1, w_latent=0.001, w_disc=0.05)
SG3 = dict(img_resolution=64, img_channels=2, num_layers=2, channel_base=1024, channel_max=32,
           z_dim=32, w_dim=32, num_critical=1, num_fp16_res=0)
G_RTOL, LOSS_RTOL, GRAD_OF_MAX = 1e-5, 1e-5, 1e-5
IMG_OF_MAX, W_ATOL = 1e-4, 1e-3
JAX_RTOL, JAX_ATOL = 1e-3, 1e-4


# ----------------------------------------------------------------------------
# Inputs and the scenarios, run alike with no mesh and on the meshes.


def _g_cfg():
    from latentaugment_tpu_torch.models.stylegan2 import networks

    return networks.generator_config(z_dim=W_DIM, w_dim=W_DIM, num_mapping_layers=2, **NET)


def _inputs(tmp):
    from latentaugment_tpu_torch.models import vgg
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3

    def tree(module):
        return checkpoint.state_dict_to_params(module.state_dict())

    rng = np.random.RandomState(13)
    g = tree(networks.Generator(_g_cfg(), seed=7))
    for block in g["synthesis"].values():
        for conv in ("conv0", "conv1"):
            if isinstance(block, dict) and conv in block:
                block[conv]["noise_strength"] = np.float32(0.2).reshape(())
    inp = dict(g=g, d=tree(networks.Discriminator(networks.discriminator_config(**NET), seed=8)),
               g3=tree(net3.Generator(net3.generator_config(**SG3), seed=9)))
    inp["vgg"] = vgg.params_to_numpy(vgg.init_vgg(3))
    inp["vgg"]["lin"] = {k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                         for k, v in inp["vgg"]["lin"].items()}
    inp["W"] = rng.randn(6, 8, W_DIM).astype(np.float32) * 0.5
    inp["X"] = rng.uniform(-1, 1, (6, 2, RES, RES)).astype(np.float32)
    inp["feas"] = [rng.randn(6, 31232).astype(np.float32) * 0.02 for _ in range(2)]
    inp["w0"] = rng.randn(B, 1, W_DIM).astype(np.float32) * 0.5
    inp["z"] = rng.randn(B, W_DIM).astype(np.float32)
    inp["z3"] = rng.randn(2, 32).astype(np.float32)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return inp


def _modules(inp):
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks

    G = networks.Generator(_g_cfg())
    G.load_state_dict(checkpoint.params_to_state_dict(inp["g"]))
    D = networks.Discriminator(networks.discriminator_config(**NET))
    D.load_state_dict(checkpoint.params_to_state_dict(inp["d"]))
    return G.requires_grad_(False), D.requires_grad_(False)


def _walk_bundle(inp, mesh):
    """The walk's functions and bundle (G, D and VGG16 split where the
    mesh has a 'model' axis) -> (fns, bundle, split names, D)."""
    from latentaugment_tpu_torch.augments import engine, losses, manifold
    from latentaugment_tpu_torch.models import vgg
    from latentaugment_tpu_torch.parallel import tensor as ptensor

    t = torch.from_numpy
    G, D = _modules(inp)
    bundle = engine.make_bundle(
        G, D, vgg.params_from_numpy(inp["vgg"]), W_summary=losses.manifold_summary(t(inp["W"])),
        X_cc_summaries=[losses.manifold_summary(manifold.center_crop(t(inp["X"]), RES)[:, m:m + 1])
                        for m in range(2)],
        fea_summaries=[losses.manifold_summary(t(f)) for f in inp["feas"]])
    names = []
    if mesh is not None:
        bundle, names = ptensor.shard_bundle(bundle, mesh)
    fns = engine.make_walk_fns(G.cfg, n_modes=2, num_epochs=K, crop_size=CROP, **WALK_W)
    return fns, bundle, names, D


def _rows(mesh, n, group=1):
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    return None if mesh is None else pmesh.shard_rows(n, mesh, group)


def _generator(inp, mesh):
    """G(z) at batch NG (const noise), and where the mesh has a 'model'
    axis: this rank's split, its weights' shapes, and the module gathered
    back from the slices."""
    from latentaugment_tpu_torch.parallel import tensor as ptensor

    G, _ = _modules(inp)
    z = torch.from_numpy(inp["z"][:NG])
    out = {}
    if mesh is not None:
        out["split"] = ptensor.shard_for_model(G, mesh)
        out["shapes"] = {k: tuple(v.shape) for k, v in G.state_dict().items()}
    rows = _rows(mesh, NG)
    img = G(z) if rows is None else rows.gather(G(rows.take(z)))
    out["img"] = img.numpy()
    if mesh is not None:
        ptensor.gather_from_model(G)
        out["gathered"] = {k: v.numpy() for k, v in G.state_dict().items()}
        out["img_gathered"] = G(z).numpy()
    return out


def _step0(inp, mesh):
    """The walk's loss terms and the gradient of its total at w0."""
    fns, bundle, names, D = _walk_bundle(inp, mesh)
    w0 = torch.from_numpy(inp["w0"])
    rows = _rows(mesh, B, D.cfg.mbstd_group_size)
    w = (w0 if rows is None else rows.take(w0)).clone().requires_grad_(True)
    with torch.enable_grad():
        total, aux = fns.loss_fn(bundle, w, (2, 4), None, rows)
        g, = torch.autograd.grad(total, w)
    aux = {k: v.detach() for k, v in aux.items()}
    if rows is not None:
        aux = {k: rows.sum(v) for k, v in aux.items()}
        g = rows.gather(g)
    return dict(aux={k: v.numpy() for k, v in aux.items()}, grad=g.numpy(), split=names)


def _walk(inp, mesh):
    fns, bundle, _, D = _walk_bundle(inp, mesh)
    w0 = torch.from_numpy(inp["w0"])
    gen = torch.Generator().manual_seed(5)
    rows = _rows(mesh, B, D.cfg.mbstd_group_size)
    if rows is None:
        img, ws, traces = fns.walk(bundle, w0, (2, 4), gen)
    else:
        img, ws, traces = fns.walk(bundle, rows.take(w0), (2, 4), gen, None, rows)
        img, ws = rows.gather(img), rows.gather(ws)
    return dict(img=img.numpy(), ws=ws.numpy(), traces={k: v.numpy() for k, v in traces.items()})


def _ganrand(inp, mesh):
    fns, bundle, _, _ = _walk_bundle(inp, mesh)
    z = torch.from_numpy(inp["z"])
    gen = torch.Generator().manual_seed(6)
    rows = _rows(mesh, B)
    if rows is None:
        img, ws = fns.ganrand(bundle, z, gen)
    else:
        img, ws = fns.ganrand(bundle, rows.take(z), gen, rows=rows)
        img, ws = rows.gather(img), rows.gather(ws)
    return dict(img=img.numpy(), ws=ws.numpy())


def _sg3(inp, mesh):
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3
    from latentaugment_tpu_torch.parallel import tensor as ptensor

    G = net3.Generator(net3.generator_config(**SG3))
    G.load_state_dict(checkpoint.params_to_state_dict(inp["g3"]))
    G.requires_grad_(False)
    split = [] if mesh is None else ptensor.shard_for_model(G, mesh)
    return dict(img=G(torch.from_numpy(inp["z3"])).numpy(), split=split)


def _policy_argv(ws_root, mesh):
    with open(os.path.join(ws_root, "argv.pkl"), "rb") as f:
        argv = pickle.load(f)
    world = 0 if mesh is None else torch.distributed.get_world_size()
    return argv + ["--device", "cpu"] + (["--n_mesh_devices", str(world), "--n_model_devices",
                                         str(M)] if mesh is not None else [])


def _policy(ws_root, mesh):
    """The policy over the workspace: one batch of 8."""
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.options import AugOptions

    opt = AugOptions().parse(argv=_policy_argv(ws_root, mesh), install_logger=False)
    augment = create_augment(opt)
    data = next(iter(create_dataset(opt)))
    augment.set_input(data)
    augment.forward()
    o = augment.get_output()
    return dict(A=o["A"], B=o["B"], w=augment.get_latent_output()["w"],
                split=augment.latent_aug.tp_split)


def _refusal(ws_root, mesh):
    """The engine over a checkpoint whose every conv has an odd width:
    the plan splits nothing, and the engine says so."""
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.options import AugOptions

    argv = _policy_argv(ws_root, mesh)
    argv[argv.index("--model_dir") + 1] = os.path.join(ws_root, "odd_ckpt.pkl")
    argv[argv.index("--w_lpips") + 1] = "0.0"
    opt = AugOptions().parse(argv=argv, install_logger=False)
    try:
        create_augment(opt)
    except ValueError as e:
        return str(e)
    return ""


def _batch_only_refusals(mesh):
    """What the paths that shard only the batch (the trainer, the metrics)
    say of a mesh with a 'model' axis."""
    from latentaugment_tpu_torch.metrics import metric_utils
    from latentaugment_tpu_torch.models.stylegan2 import networks, train

    out = []
    for make in (lambda: train.make_train_fns(
                     networks.generator_config(**NET), networks.discriminator_config(**NET),
                     train.train_config(batch_size=B), device="cpu", mesh=mesh),
                 lambda: metric_utils.MetricOptions(device="cpu", mesh=mesh)):
        try:
            make()
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


def scenarios(inp, mesh, tmp):
    world = 1 if mesh is None else torch.distributed.get_world_size()
    out = dict(g=_generator(inp, mesh), step0=_step0(inp, mesh))
    if world != 2:
        out.update(walk=_walk(inp, mesh), ganrand=_ganrand(inp, mesh),
                   policy=_policy(os.path.join(tmp, "ws"), mesh))
    if world != 4:
        out["sg3"] = _sg3(inp, mesh)
    if world == 2:
        out["refused"] = _refusal(os.path.join(tmp, "ws"), mesh)
    return out


def _worker(rank, port, tmp, world):
    torch.set_num_threads(1)
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    mesh = pmesh.get_mesh(world, devices="cpu", n_model=M)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = scenarios(inp, mesh, tmp)
    out["batch_only"] = _batch_only_refusals(mesh)
    out["mesh"] = dict(dims=mesh.mesh_dim_names, shape=tuple(mesh.mesh.shape),
                       data_ranks=pmesh.mesh_ranks(mesh), data_rank=pmesh.data_rank(mesh),
                       model_rank=pmesh.model_rank(mesh), world=pmesh.world_size(mesh))
    with open(os.path.join(tmp, f"rank{rank}_of{world}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    sys.path[:0] = [REPO, HERE]
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    sys.exit(0)

# ----------------------------------------------------------------------------
# The tests (the parent side imports JAX).

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from test_torch_port_common import _one_torch_thread  # noqa: E402,F401 (autouse fixture)


def _workspace(root):
    from latentaugment_tpu_torch import benchmark
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks

    argv = benchmark.build_policy_workspace(
        root, res=RES, batch_size=B, num_epochs=2, crop_size=CROP, channel_base=256,
        channel_max=32, n_patients=1, slices_per_patient=8, step=3)
    with open(os.path.join(root, "argv.pkl"), "wb") as f:
        pickle.dump(argv, f)
    g_cfg, d_cfg = benchmark.make_gd_configs(RES, 2, 96, 3, 0)
    checkpoint.save_checkpoint(os.path.join(root, "odd_ckpt.pkl"), networks.Generator(g_cfg),
                               networks.Discriminator(d_cfg))


def _jax_side(inp):
    """JAX's generator at batch NG, unsplit and under its TP jit on a
    (data 2, model 2) mesh of 4 CPU devices."""
    from latentaugment_tpu.models.stylegan2 import networks as net_j
    from latentaugment_tpu.parallel import mesh as pmesh_j

    cfg = net_j.generator_config(z_dim=W_DIM, w_dim=W_DIM, num_mapping_layers=2, **NET)
    params = jax.tree_util.tree_map(jnp.asarray, inp["g"])
    z = jnp.asarray(inp["z"][:NG])
    mesh = pmesh_j.get_mesh(4, n_model=M)
    sh = pmesh_j.tp_tree_shardings(params, mesh)
    batch = pmesh_j.batch_sharding(mesh)
    f = jax.jit(lambda p, zz: net_j.generator_apply(p, cfg, zz), in_shardings=(sh, batch),
                out_shardings=batch)
    return dict(g_tp=np.asarray(f(jax.device_put(params, sh), jax.device_put(z, batch))),
                n_split=sum(1 for s in jax.tree_util.tree_leaves(sh) if s.spec != P()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    tmp = str(tmp_path_factory.mktemp("tensor_parallel"))
    inp = _inputs(tmp)
    _workspace(os.path.join(tmp, "ws"))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO + os.pathsep + HERE, OMP_NUM_THREADS="1")

    def start_group(world):
        port = pmesh.free_port()
        return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                                  tmp, str(world)], cwd=tmp, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for r in range(world)]

    procs = start_group(2)
    box = {}

    def jax_job():
        try:
            box["out"] = _jax_side(inp)
        except BaseException as e:  # re-raised below
            box["err"] = e

    thread = threading.Thread(target=jax_job)
    thread.start()
    try:
        single = scenarios(inp, None, tmp)
        thread.join(timeout=600)
        assert not thread.is_alive(), "the JAX side did not finish"
        if "err" in box:
            raise box["err"]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        procs += start_group(4)
        logs += [p.communicate(timeout=600)[0] for p in procs[2:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r} failed:\n{log[-6000:]}"
    ranks = {}
    for world in (2, 4):
        ranks[world] = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}_of{world}.pkl"), "rb") as f:
                ranks[world].append(pickle.load(f))
    return dict(inp=inp, single=single, ranks=ranks, jax=box["out"], ws=os.path.join(tmp, "ws"))


def _close(got, want, rtol, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


# ---- (a) the plan: the JAX rule on the same parameters.


def _jax_split(tree, n_model):
    from latentaugment_tpu.parallel import mesh as pmesh_j

    mesh = pmesh_j.get_mesh(4, n_model=n_model)
    sh = pmesh_j.tp_tree_shardings(jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    leaves = jax.tree_util.tree_leaves_with_path(sh)
    return sorted(".".join(str(k.key) for k in path) for path, s in leaves if s.spec != P())


@pytest.mark.parametrize("net", ["G", "D", "vgg", "sg3"])
def test_plan_splits_exactly_the_leaves_tp_tree_shardings_splits(runs, net):
    from latentaugment_tpu_torch.models import vgg
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3
    from latentaugment_tpu_torch.parallel import tensor as ptensor

    inp = runs["inp"]
    if net == "vgg":
        tree, params = inp["vgg"], vgg.params_from_numpy(inp["vgg"])
    else:
        tree = {"G": inp["g"], "D": inp["d"], "sg3": inp["g3"]}[net]
        params = (net3.Generator(net3.generator_config(**SG3)) if net == "sg3" else
                  networks.Generator(_g_cfg()) if net == "G" else
                  networks.Discriminator(networks.discriminator_config(**NET)))
        params.load_state_dict(checkpoint.params_to_state_dict(tree))
    want = _jax_split(tree, M)
    assert want, "the JAX rule splits nothing here"
    assert sorted(ptensor.plan(params, M)) == want
    # Both keep toRGB (2 output channels) whole.
    assert not [n for n in want if "torgb" in n or n.startswith("L2_")]
    assert ptensor.plan(params, 1) == [] and _jax_split(tree, 1) == []


def test_a_model_axis_must_divide_the_ranks():
    from latentaugment_tpu.parallel import mesh as pmesh_j

    from latentaugment_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError):
        pmesh_j.get_mesh(4, n_model=3)
    with pytest.raises(ValueError, match="must divide"):
        pmesh.get_mesh(4, n_model=3)


def test_the_mesh_splits_the_batch_over_the_data_axis_only(runs):
    for world, n_data in ((2, 1), (4, 2)):
        for r, rec in enumerate(runs["ranks"][world]):
            m = rec["mesh"]
            assert m["dims"] == ("data", "model") and m["shape"] == (n_data, M)
            assert (m["data_rank"], m["model_rank"]) == divmod(r, M)
            assert m["world"] == n_data and m["data_ranks"] == list(range(r % M, world, M))


# ---- (b) G against one process and JAX's TP jit.


@pytest.mark.parametrize("world", [2, 4])
def test_generator_matches_one_process_and_jax(runs, world):
    single = runs["single"]["g"]["img"]
    for rec in runs["ranks"][world]:
        _close(rec["g"]["img"], single, G_RTOL, G_RTOL * np.abs(single).max())
        _close(rec["g"]["img"], runs["jax"]["g_tp"], JAX_RTOL, JAX_ATOL)
    assert runs["jax"]["n_split"] == len(runs["ranks"][world][0]["g"]["split"])


def test_each_rank_holds_its_slice_and_the_slices_give_the_module_back(runs):
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint

    full = checkpoint.params_to_state_dict(runs["inp"]["g"])
    for world in (2, 4):
        for rec in runs["ranks"][world]:
            g = rec["g"]
            assert g["split"]
            for name, shape in g["shapes"].items():
                want = tuple(full[name].shape)
                layer = name.rsplit(".", 1)[0]
                if f"{layer}.weight" in g["split"] and name.endswith((".weight", ".bias")):
                    want = (want[0] // M, *want[1:])
                assert shape == want, name
            for name, value in g["gathered"].items():
                np.testing.assert_array_equal(value, np.asarray(full[name]), err_msg=name)
            np.testing.assert_array_equal(g["img_gathered"], runs["single"]["g"]["img"])


# ---- (c) the walk at step 0: losses and the w-gradient.


@pytest.mark.parametrize("world", [2, 4])
def test_walk_step0_loss_and_gradient_match_one_process(runs, world):
    single = runs["single"]["step0"]
    scale = np.abs(single["grad"]).max()
    assert scale > 0
    for rec in runs["ranks"][world]:
        s0 = rec["step0"]
        assert [n for n in s0["split"] if n.startswith("vgg.")], "VGG16 was not split"
        for name, value in single["aux"].items():
            _close(s0["aux"][name], value, LOSS_RTOL, 1e-8, err_msg=name)
        err = np.abs(s0["grad"] - single["grad"]).max() / scale
        assert err <= GRAD_OF_MAX, f"w-gradient off by {err} of its max on {world} ranks"


# ---- (d) the K-step walk and forward_ganrand on 2 x 2.


def test_k_step_walk_matches_one_process(runs):
    single = runs["single"]["walk"]
    for rec in runs["ranks"][4]:
        got = rec["walk"]
        for part in ("img", "ws"):
            _close(got[part], single[part], 0, IMG_OF_MAX * np.abs(single[part]).max(),
                   err_msg=part)
        _close(got["ws"][:, :1], single["ws"][:, :1], 0, W_ATOL)
        for name, trace in single["traces"].items():
            _close(got["traces"][name], trace, 1e-5, 1e-7, err_msg=name)
    moved = np.abs(single["ws"][:, :1] - runs["inp"]["w0"]).mean()
    assert moved > 5e-3, f"the walk barely moved w ({moved})"


def test_forward_ganrand_matches_one_process(runs):
    single = runs["single"]["ganrand"]
    for rec in runs["ranks"][4]:
        for part in ("img", "ws"):
            _close(rec["ganrand"][part], single[part], G_RTOL,
                   G_RTOL * np.abs(single[part]).max(), err_msg=part)


def test_every_rank_returns_the_global_result(runs):
    first, *rest = runs["ranks"][4]
    for rec in rest:
        for key in ("walk", "ganrand"):
            for part in ("img", "ws"):
                np.testing.assert_array_equal(rec[key][part], first[key][part], err_msg=key)
        np.testing.assert_array_equal(rec["policy"]["A"], first["policy"]["A"])


# ---- (e) the policy.


def _synthesize(ws_root, w):
    """The 1-process G's images of the walked codes w [B, w_dim], with the
    noise the policy's engine draws for its first batch."""
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from latentaugment_tpu_torch.options import AugOptions

    opt = AugOptions().parse(argv=_policy_argv(ws_root, None), install_logger=False)
    g_params, g_cfg, _, _ = checkpoint.load_stylegan(opt.model_dir)
    g_cfg.num_fp16_res = 0  # a 32x32 walk runs all in float32
    G = networks.Generator(g_cfg)
    G.load_state_dict(checkpoint.params_to_state_dict(g_params))
    ws = torch.from_numpy(w)[:, None, :].repeat(1, g_cfg.num_ws, 1)
    with torch.no_grad():
        img = G.synthesis(ws, noise_mode="random",
                          generator=torch.Generator().manual_seed(opt.seed + 3))
    return img.numpy()


def test_policy_with_n_model_devices_matches_one_process(runs):
    """The walked w within W_ATOL of one process's; the images exactly
    what the 1-process G makes of the walked w (an image moves with its w:
    here up to 3e-4 for a w moved 2e-4)."""
    single = runs["single"]["policy"]
    assert single["A"].shape == (B, 1, RES, RES) and single["split"] == []
    for rec in runs["ranks"][4]:
        got = rec["policy"]
        assert got["split"] and got["A"].shape == (B, 1, RES, RES)
        _close(got["w"], single["w"], 0, W_ATOL)
        img = _synthesize(runs["ws"], got["w"])
        for k, part in enumerate("AB"):
            _close(got[part], img[:, k:k + 1], G_RTOL, G_RTOL * np.abs(img).max(), err_msg=part)


def test_engine_refuses_a_model_axis_that_splits_nothing(runs):
    for rec in runs["ranks"][2]:
        assert "no conv weight" in rec["refused"] and "n_model_devices" in rec["refused"]


def test_trainer_and_metrics_refuse_a_model_axis(runs):
    for world in (2, 4):
        for rec in runs["ranks"][world]:
            for msg in rec["batch_only"]:
                assert "shards only the batch" in msg and "n_model=1" in msg


def test_n_model_devices_without_n_mesh_devices_raises(tmp_path):
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.options import AugOptions

    argv = ["--dataroot", "x.zip", "--aug", "latent", "--model_dir", "m", "--interim_dir", "i",
            "--checkpoints_dir", str(tmp_path), "--device", "cpu", "--n_model_devices", "2"]
    opt = AugOptions().parse(argv=argv, install_logger=False)
    with pytest.raises(ValueError, match="n_mesh_devices"):
        create_augment(opt)


# ---- (f) StyleGAN3-T on 1 x 2.


def test_sg3_generator_matches_one_process(runs):
    single = runs["single"]["sg3"]
    for rec in runs["ranks"][2]:
        got = rec["sg3"]
        assert got["split"] and all(n.endswith(".weight") for n in got["split"])
        _close(got["img"], single["img"], G_RTOL, G_RTOL * np.abs(single["img"]).max())
