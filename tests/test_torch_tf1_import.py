"""The port's TF1 import (`train/tf1_import.py`) against the JAX package's
(`dpig_tpu/train/tf1_import.py`).

The JAX file's own cases on the port's modules: positional pairing in
creation order (mapper, U-net generator, both ROI encoders), shape and
count mismatches raising, the slim sort key. Then one TF1 bundle (written
by `tf.raw_ops.SaveV2`, eagerly) of every scope at the tiny Market
geometry, imported by the JAX package (`import_checkpoint`, then
`bridge.params_from_flax`) and by the port: every sub-tree bit-equal,
the D's permuted `Output.W` and BatchNorm statistics included (the JAX
side's template is the port's in flax's layout, `flax_template`); a
model-12
batch from each import within the model-12 CPU tolerance
(tests/test_torch_transfer.py); the CLI's checkpoint taken by the
`--pretrained_*` flags and by `--ckpt_path`, and its `scopes not found`
line for an unrelated bundle. The same at a tiny DeepFashion 256
geometry (256x256, hidden 4: the single-branch encoder, the generator at
repeat_num-1, the 5-stage D, the pose AE, the pose mapper and the single
appearance mapper `Gaussian_FC`), with a model-1001 batch from each
import."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorflow as tf
import torch

from dpig_tpu.apps import testers as jtesters
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.train import tf1_import as jt1
from dpig_tpu_torch.apps import testers
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.models.encoders import RoiEncoder, RoiEncoderFgBg
from dpig_tpu_torch.models.generator import UAEGenerator
from dpig_tpu_torch.models.mappers import GaussianMapper
from dpig_tpu_torch.train import checkpoint as ckpt
from dpig_tpu_torch.train import tf1_import as t1

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)


@pytest.fixture(scope="module", autouse=True)
def tf_eager():
    """TensorFlow runs eagerly here whatever an earlier test of this
    worker left on (tests/test_tf1_import.py turns graph mode on for the
    rest of its process), and as it was after this module."""
    from tensorflow.python.eager import context
    with context.eager_mode():
        yield


def _mk(shape, marker):
    return np.full(shape, float(marker), np.float32)


def _state(module):
    return dict(module.state_dict())


def _mapper():
    # GaussianMapper(out 16, hidden 8, repeat 2): trunk Dense_0 (in->8),
    # Dense_1..4 (8->8), final Dense_0 (8->16)
    return _state(GaussianMapper(16, 16, 8, repeat_num=2))


def test_mapper_import_order():
    shapes = [(16, 8)] + [(8, 8)] * 4 + [(8, 16)]
    var = {}
    for i, s in enumerate(shapes):
        base = "Gaussian_FC_Fg/G_FC/fully_connected" + ("" if i == 0
                                                        else f"_{i}")
        var[f"{base}/weights"] = _mk(s, i + 1)
        var[f"{base}/biases"] = _mk((s[1],), -(i + 1))
    filled = t1.import_scope(var, "Gaussian_FC_Fg/G_FC", "mapper", _mapper())
    assert filled["FCResTrunk_0.Dense_0.weight"][0, 0] == 1
    assert filled["FCResTrunk_0.Dense_4.weight"][0, 0] == 5
    assert filled["Dense_0.weight"][0, 0] == 6  # final projection
    assert filled["Dense_0.bias"][0] == -6
    assert filled["Dense_0.weight"].shape == (16, 8)  # [in,out] -> [out,in]


def test_uae_generator_import_order():
    gen = _state(UAEGenerator(32, 16, emb_dim=52, pose_ch=18, out_channels=3,
                              z_num=16, repeat_num=3, hidden_num=8))
    order = t1.flax_stream_order("uae_generator", gen)
    conv_paths = [p for p in order if p in ("stem", "to_rgb")
                  or p.startswith(("ConvBlockTower_0/", "Conv_"))]
    fc_paths = [p for p in order if p in ("bottleneck", "unbottleneck")]
    var = {}
    for family, paths, marker in (("Conv", conv_paths, 100),
                                  ("fully_connected", fc_paths, 200)):
        for i, p in enumerate(paths):
            w, b = t1._keys(p)
            base = f"ID_AE/G/{family}" + ("" if i == 0 else f"_{i}")
            var[f"{base}/weights"] = _mk(t1._ref_shape(gen[w]), marker + i)
            var[f"{base}/biases"] = _mk(gen[b].shape, -(marker + i))
    filled = t1.import_scope(var, "ID_AE/G", "uae_generator", gen)
    assert filled["stem_kernel"][0, 0, 0, 0] == 100        # first ref conv
    assert filled["stem_bias"][0] == -100
    assert filled["to_rgb.weight"][0, 0, 0, 0] == 100 + len(conv_paths) - 1
    assert filled["bottleneck.weight"][0, 0] == 200
    assert filled["unbottleneck.weight"][0, 0] == 201
    # encoder convs come before decoder convs
    assert filled["ConvBlockTower_0.Conv_0.weight"][0, 0, 0, 0] == 101
    assert filled["Conv_0.weight"][0, 0, 0, 0] == 109      # first dec conv


def _mapper_var(scope, shapes):
    return {f"{scope}/fully_connected" + ("" if i == 0 else f"_{i}")
            + "/weights": _mk(s, i) for i, s in enumerate(shapes)}


def test_shape_mismatch_fails_loudly():
    var = _mapper_var("X/G_FC", [(16, 8)] + [(8, 8)] * 4 + [(8, 16)])
    var["X/G_FC/fully_connected_2/weights"] = _mk((3, 3), 0)
    with pytest.raises(ValueError, match="shape mismatch"):
        t1.import_scope(var, "X/G_FC", "mapper", _mapper())
    # the JAX package raises on the same bundle
    with pytest.raises(ValueError, match="shape mismatch"):
        jt1.import_scope(var, "X/G_FC", "mapper", _flax_mapper())


def test_count_mismatch_fails_loudly():
    var = {"X/G_FC/fully_connected/weights": _mk((16, 8), 1)}
    with pytest.raises(ValueError, match="architecture mismatch") as err:
        t1.import_scope(var, "X/G_FC", "mapper", _mapper())
    assert "fully_connected/weights" in str(err.value)     # both lists
    assert "FCResTrunk_0/Dense_4" in str(err.value)
    with pytest.raises(ValueError, match="architecture mismatch"):
        jt1.import_scope(var, "X/G_FC", "mapper", _flax_mapper())


def _flax_mapper():
    from dpig_tpu.models.mappers import GaussianMapper as JaxMapper
    m = JaxMapper(out_dim=16, hidden_num=8, repeat_num=2)
    return jax.tree_util.tree_map(np.asarray, m.init(
        jax.random.PRNGKey(0), np.zeros((2, 16), np.float32))["params"])


def test_slim_sort_key_ordering():
    names = ["s/Conv_10/weights", "s/Conv/weights", "s/Conv_2/weights",
             "s/fully_connected/weights"]
    want = ["s/Conv/weights", "s/Conv_2/weights", "s/Conv_10/weights",
            "s/fully_connected/weights"]
    assert sorted(names, key=t1._slim_sort_key) == want
    assert sorted(names, key=jt1._slim_sort_key) == want


def test_encoder_stream_orders_resolve():
    """Every path of the orders is a weight of the real encoders; stem
    convs first, the FG tower, the BG tower, then the two FCs."""
    enc = _state(RoiEncoderFgBg(32, 16, part_num=7, z_num=8, repeat_num=3,
                                hidden_num=8, roi_size=8))
    order = t1.flax_stream_order("roi_encoder_fgbg", enc)
    for path in order:
        assert t1._keys(path)[0] in enc, path
    assert order[0].startswith("_Stem_0/")
    assert order[-2:] == ["fg_tower/Dense_0", "bg_fc"]
    enc2 = _state(RoiEncoder(part_num=7, z_num=8, repeat_num=3, hidden_num=8,
                             roi_size=8))
    order2 = t1.flax_stream_order("roi_encoder", enc2)
    for path in order2:
        assert t1._keys(path)[0] in enc2, path
    assert order2[-1] == "_RoiTower_0/Dense_0"
    assert len(order2) == sum(k.endswith(".weight") for k in enc2)


# ----------------------------------------------- the JAX package's import
def flax_template(state):
    """The port's template as the JAX package's param trees, the inverse
    of `bridge.params_from_flax` (its tests hold the two packages' trees
    to each other): nested on the dots, conv weights OIHW -> HWIO `kernel`,
    dense weights [out, in] -> [in, out], BatchNorm weights -> `scale`,
    the D's running statistics -> `Discriminator_stats` mean / var. Every
    leaf the import writes is replaced, so only the structure counts."""
    out = {}
    for sub, tensors in state.items():
        trees = {sub: {}, f"{sub}_stats": {}}
        for key, t in tensors.items():
            *path, leaf = key.split(".")
            stats = leaf in ("running_mean", "running_var")
            node = trees[f"{sub}_stats" if stats else sub]
            for k in path:
                node = node.setdefault(k, {})
            a = t.numpy()
            if stats:
                node["mean" if leaf == "running_mean" else "var"] = a
            elif a.ndim == 4:
                node["kernel" if leaf == "weight" else leaf] = \
                    a.transpose(2, 3, 1, 0)
            elif leaf == "weight":
                node["kernel" if a.ndim == 2 else "scale"] = \
                    a.T if a.ndim == 2 else a
            else:
                node[leaf] = a
        out.update({k: v for k, v in trees.items() if v})
    return out


def seeded_variables(template, h, w, seed):
    """The reference variables of `template`'s shapes (`reference_variables`
    names them), with seeded values: normal weights, positive BatchNorm
    variances; plus the optimizer slots and a beta power the readers drop."""
    rng = np.random.default_rng(seed)
    var = {}
    for name, v in t1.reference_variables(template, h, w).items():
        if name.endswith("moving_variance"):
            var[name] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        else:
            var[name] = rng.normal(0, 0.05, v.shape).astype(np.float32)
    var["ID_AE/G/Conv/weights/Adam"] = np.zeros(3, np.float32)
    var["Discriminator.1.Filters/RMSProp_1"] = np.zeros(3, np.float32)
    var["beta1_power"] = np.float32(0.9)
    return var


def save_v2(prefix, var):
    names = sorted(var)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(var[n]) for n in names])
    return prefix


def jax_import_as_port(imported):
    """The JAX import through `bridge.params_from_flax`, the D's
    statistics merged into its state as the port keeps them."""
    names = [k for k in imported if k != "Discriminator_stats"]
    state = params_from_flax(imported, names + ["Discriminator_stats"])
    state["Discriminator"].update(state.pop("Discriminator_stats"))
    return state


def assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for sub, tensors in want.items():
        assert sorted(got[sub]) == sorted(tensors), sub
        for n, t in tensors.items():
            assert got[sub][n].dtype == t.dtype, (sub, n)
            assert torch.equal(got[sub][n], t), (sub, n)


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("t1")
    cfg = Config(platform="cpu", model_dir=str(tmp / "m12"), **SMALL)
    template = t1.template_state(cfg)
    var = seeded_variables(template, 32, 16, seed=4)
    prefix = save_v2(str(tmp / "ref" / "model.ckpt-1000"), var)
    jax_params = flax_template(template)
    assert params_from_flax(jax_params, list(jax_params)).keys() == \
        {*template, "Discriminator_stats"}
    jimported = jt1.import_checkpoint(prefix, jax_params, img_h=32, img_w=16)
    port = t1.import_checkpoint(prefix, template, img_h=32, img_w=16)
    return dict(tmp=tmp, cfg=cfg, template=template, var=var, prefix=prefix,
                jax_params=jax_params, jimported=jimported, port=port)


def test_import_equals_the_jax_package_bit_for_bit(market):
    want = jax_import_as_port(market["jimported"])
    assert sorted(want) == ["Discriminator", "Encoder", "Gaussian_FC",
                            "Gaussian_FC_Bg", "Gaussian_FC_Fg", "ID_AE",
                            "PoseAE", "PoseGaussian"]
    assert_bit_equal(market["port"], want)
    var = market["var"]
    d = market["port"]["Discriminator"]
    assert torch.equal(d["BatchNorm_1.running_var"], torch.from_numpy(
        var["Discriminator.BN3.moving_variance"]))
    # Output.W rows moved from the NCHW flatten (c, h, w) to (h, w, c)
    w = var["Discriminator.Output.W"]                  # [512 * 2 * 1, 1]
    assert torch.equal(d["logit.weight"][0], torch.from_numpy(
        w.reshape(512, 2, 1).transpose(1, 2, 0).reshape(-1)))


def test_model12_batch_from_each_import(market):
    """The JAX tester on JAX's import and the port's on the port's: the
    same transfer_step outputs within the model-12 CPU tolerance."""
    params = {**market["jax_params"], **market["jimported"]}

    class Imported(jtesters.ConditionalTransferTester):
        def _restore_params(self):
            return params

    jt = Imported(JaxConfig(model_dir=str(market["tmp"] / "j12"), **SMALL))
    t = testers.ConditionalTransferTester(market["cfg"], params={
        k: market["port"][k] for k in ("Encoder", "ID_AE", "Discriminator")})
    batch = next(JaxLoader(4, 32, 16, seed=3))
    g_ref, pose_ref, score_ref = jt.transfer_step(
        jt.params, {k: jnp.asarray(v) for k, v in batch.items()})
    g, pose, score = t.transfer_step(batch_to_device(batch, t.device))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(pose.numpy(), np.asarray(pose_ref))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref),
                               atol=1e-4, rtol=0)


def _cli(prefix, out, **extra):
    flags = {**SMALL, **extra}
    return t1.main([f"--ckpt_path={prefix}", f"--model_dir={out}",
                    "--platform=cpu",
                    *(f"--{k}={v}" for k, v in flags.items())])


def test_cli_checkpoint_feeds_the_pretrained_flags(market, capsys):
    out = str(market["tmp"] / "imported")
    sizes = _cli(market["prefix"], out)
    text = capsys.readouterr().out
    assert "scopes not found" not in text and "[*] imported" in text
    assert sizes["bundle_bytes"] > 0
    tree = ckpt.load_tree(out)
    assert tree["step"] == 0 and "g_opt_state" not in tree
    for sub, tensors in market["port"].items():
        got = tree["g_params"].get(sub) or {**tree["d_params"][sub],
                                             **tree["d_stats"][sub]}
        for n, t in tensors.items():
            assert torch.equal(got[n], t), (sub, n)
    flags = dict(pretrained_path=out, pretrained_poseAE_path=out,
                 pretrained_appSample_path=out,
                 pretrained_poseSample_path=out)
    t = testers.FullSamplingTester(Config(
        platform="cpu", model_dir=str(market["tmp"] / "m11"), **SMALL,
        **flags))
    assert "RANDOM" not in capsys.readouterr().out
    state = t.cpu_state()
    for sub in ("Encoder", "ID_AE", "PoseAE", "PoseGaussian",
                "Gaussian_FC_Fg", "Gaussian_FC_Bg"):
        for n, v in state[sub].items():
            assert torch.equal(v, market["port"][sub][n]), (sub, n)


def test_cli_checkpoint_resumes_through_ckpt_path(market, tmp_path):
    """Model 1 with --ckpt_path on the imported checkpoint: the imported
    Stage-I nets and D, fresh optimizers, step 0, one step taken."""
    from dpig_tpu_torch.main import main as port_main
    out = str(market["tmp"] / "imported_resume")
    _cli(market["prefix"], out)
    run = str(tmp_path / "m1")
    port_main(["--model=1", "--platform=cpu", "--synthetic_data=true",
               "--max_step=1", "--log_step=1", f"--ckpt_path={out}",
               f"--model_dir={run}", *(f"--{k}={v}" for k, v in
                                       SMALL.items())])
    tree = ckpt.load_tree(run)
    assert tree["step"] == 1 and tree["g_opt_state"]["count"] == 1
    before = market["port"]["ID_AE"]["to_rgb.weight"]
    after = tree["g_params"]["ID_AE"]["to_rgb.weight"]
    assert 0 < float((after - before).abs().max()) < 1e-3  # one Adam step


def test_cli_reports_scopes_not_found(tmp_path, capsys):
    prefix = save_v2(str(tmp_path / "unrelated"),
                     {"unrelated/var": np.zeros(3, np.float32)})
    out = str(tmp_path / "out")
    _cli(prefix, out)
    assert "scopes not found" in capsys.readouterr().out
    tree = ckpt.load_tree(out)
    assert "d_params" not in tree
    for sub in ("Encoder", "ID_AE", "PoseAE", "PoseGaussian",
                "Gaussian_FC_Fg", "Gaussian_FC_Bg", "Gaussian_FC"):
        assert sub in tree["g_params"], sub


# ------------------------------------------ DeepFashion 256 (hidden 4)
# The JAX package's table pairs 'Encoder/G_encoder' with the FG/BG encoder
# only, so its `import_checkpoint` raises a KeyError on the family's
# template (the single-branch encoder); its encoder reference here is its
# own `import_scope` with the single-branch kind, the one the port picks.
NARROW = dict(img_H=256, img_W=256, batch_size=2, conv_hidden_num=4,
              z_num=4)
DF_NETS = ("Encoder", "ID_AE", "Discriminator", "PoseAE", "PoseGaussian",
           "Gaussian_FC")


@pytest.fixture(scope="module")
def imports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("t1_256")
    cfg = Config(platform="cpu", model_dir=str(tmp / "m"), **NARROW)
    template = t1.template_state(cfg)
    assert not any(k.startswith("fg_tower.") for k in template["Encoder"])
    df = {k: template[k] for k in DF_NETS}
    var = seeded_variables(df, 256, 256, seed=6)
    prefix = save_v2(str(tmp / "ref" / "model.ckpt"), var)
    jtemplate = flax_template(df)
    with pytest.raises(KeyError, match="fg_tower"):
        jt1.import_checkpoint(prefix, jtemplate, img_h=256, img_w=256)
    scopes = [s for s in jt1.SCOPE_TABLE if s != "Encoder/G_encoder"]
    jimported = jt1.import_checkpoint(prefix, jtemplate,
                                      scopes + ["Discriminator"],
                                      img_h=256, img_w=256)
    jimported["Encoder"] = jt1.import_scope(
        jt1.load_tf1_variables(prefix), "Encoder/G_encoder", "roi_encoder",
        jtemplate["Encoder"])
    port = t1.import_checkpoint(prefix, template, img_h=256, img_w=256)
    return dict(tmp=tmp, cfg=cfg, jparams=jtemplate, jimported=jimported,
                port=port)


def test_import_at_256_equals_the_jax_package_bit_for_bit(imports):
    assert sorted(imports["port"]) == sorted(DF_NETS)
    assert imports["port"]["Discriminator"]["logit.weight"].shape == (
        1, 8 * 8 * 512)
    assert_bit_equal(imports["port"], jax_import_as_port(imports["jimported"]))


def test_model1001_batch_from_each_import(imports):
    params = {**imports["jparams"], **imports["jimported"]}

    class Imported(jtesters.ConditionalTransferTester):
        def _restore_params(self):
            return params

    jt = Imported(JaxConfig(model_dir=str(imports["tmp"] / "j1001"),
                            **NARROW))
    t = testers.ConditionalTransferTester(imports["cfg"], params={
        k: imports["port"][k] for k in ("Encoder", "ID_AE", "Discriminator")})
    assert params_from_flax(params, ["ID_AE"])["ID_AE"].keys() == \
        imports["port"]["ID_AE"].keys()
    batch = next(JaxLoader(2, 256, 256, seed=4))
    g_ref, pose_ref, score_ref = jt.transfer_step(
        jt.params, {k: jnp.asarray(v) for k, v in batch.items()})
    g, pose, score = t.transfer_step(batch_to_device(batch, t.device))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref, np.float32),
                               atol=2e-2, rtol=0)
    np.testing.assert_array_equal(pose.numpy(), np.asarray(pose_ref))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref,
                                                         np.float32),
                               atol=1e-4, rtol=0)
