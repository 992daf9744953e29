"""The port's experiment harness (``lidar_transfer_tpu_torch/experiments/``)
against the JAX package's on the 16x256 ``synthetic_dataset`` of
``tests/conftest.py``.

The whole slice: the JAX trainer takes one step of the ``tiny`` config
(float32 compute) and writes a checkpoint; ``interop`` turns its
parameters and optax Adam state into a port checkpoint; both trainers
resume from there to step 3 on the same sampling stream. Tolerances: the
final parameters within 1e-4 on >= 99.9 % of entries, and every entry
within 2e-3 (float32 convolutions summed in another order: an entry whose
gradient is at rounding noise takes an Adam step of up to lr = 1e-3 in
either direction; measured 8.3e-4 on 32 of 104,000 entries, the rest within
1e-4, while the steps moved every entry by some 2e-3); the predictions of the
two resumed models on >= 99.9 % of points (a pixel whose two best logits
lie within that difference, or a point on a pixel boundary, can go either
way); ``evaluate_semantics`` of the port on the JAX predictions equal to
JAX's dict; the label mapper, the class histograms and the cp grid cell's
metrics equal. The JAX trainer runs once, in the module fixture.
"""

import dataclasses
import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.config import TransferConfig as JTransferConfig
from lidar_transfer_tpu.experiments import segmentation as JS
from lidar_transfer_tpu.experiments.compare_datasets import (
    compare_datasets as j_compare_datasets)
from lidar_transfer_tpu.experiments.grid_search import (
    evaluate_transfer as j_evaluate_transfer)
from lidar_transfer_tpu.models import RangeNetConfig as JRangeNetConfig
from lidar_transfer_tpu_torch import interop
from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.experiments import segmentation as TS
from lidar_transfer_tpu_torch.experiments import workflows as TW
from lidar_transfer_tpu_torch.experiments.compare_datasets import (
    compare_datasets)
from lidar_transfer_tpu_torch.experiments.grid_search import (
    evaluate_transfer, grid_search)
from lidar_transfer_tpu_torch.models import RangeNet, RangeNetConfig
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


SEED = 5
MAPPER = TS.LabelMapper.from_labels(dict(TransferConfig().labels))
TCFG = dataclasses.replace(
    RangeNetConfig.tiny(num_classes=MAPPER.num_classes),
    compute_dtype=torch.float32)
JCFG = dataclasses.replace(
    JRangeNetConfig.tiny(num_classes=MAPPER.num_classes),
    compute_dtype=jnp.float32)


def small_cfg(**kw):
    base = dict(adaption="cp", number_of_scans=1, voxel_size=0.25,
                voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))
    base.update(kw)
    return TransferConfig(**base)


def _port_checkpoint(blob, path):
    """A JAX checkpoint blob (numpy trees) -> the port's checkpoint at
    ``path``, through ``interop``."""
    model = RangeNet(TCFG)
    model.load_state_dict(interop.rangenet_state_dict(blob["params"], TCFG))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    adam = blob["opt_state"][0]
    opt.load_state_dict(interop.adam_state_from_optax(
        opt, model, adam.mu, adam.nu, adam.count))
    jm = blob["mapper"]
    mapper = TS.LabelMapper(raw_ids=jm.raw_ids,
                            raw_to_index=jm.raw_to_index,
                            ignore_indices=jm.ignore_indices)
    spec = SensorSpec(**dataclasses.asdict(blob["spec"]))
    TS.save_checkpoint(path, model, mapper, spec, optimizer=opt,
                       step=blob["step"], sampling=blob["sampling"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, synthetic_dataset):
    """JAX: one step with a checkpoint, then resumed to step 3, its
    predictions (with and without kNN) and their evaluation. The port:
    the same checkpoint through ``interop``, resumed to step 3."""
    d = tmp_path_factory.mktemp("seg")
    kw = dict(model_cfg=JCFG, verbose=False, use_mesh=False, seed=SEED)
    j1 = str(d / "jax1.pkl")
    JS.train_segmentation(synthetic_dataset, steps=1, checkpoint_path=j1,
                          **kw)
    with open(j1, "rb") as f:
        blob = pickle.load(f)
    j3 = str(d / "jax3.pkl")
    shutil.copy(j1, j3)
    JS.train_segmentation(synthetic_dataset, steps=3, checkpoint_path=j3,
                          resume=True, **kw)
    jmodel, jparams, jmapper, jspec = JS.load_checkpoint(j3)
    out = {"blob": blob, "jax_params": jparams, "dir": d}
    for knn in (False, True):
        root = str(d / f"jax_pred_{knn}")
        JS.write_predictions(synthetic_dataset, root, jmodel, jparams,
                             jmapper, jspec, verbose=False, knn=knn)
        out[f"jax_pred_{knn}"] = root
    out["jax_eval"] = JS.evaluate_semantics(synthetic_dataset,
                                            out["jax_pred_False"])

    t1 = str(d / "port1.pt")
    _port_checkpoint(blob, t1)
    t3 = str(d / "port3.pt")
    shutil.copy(t1, t3)
    model, mapper, spec = TS.train_segmentation(
        synthetic_dataset, steps=3, model_cfg=TCFG, verbose=False,
        seed=SEED, checkpoint_path=t3, resume=True, device="cpu")
    out.update(port1=t1, port3=t3, model=model, mapper=mapper, spec=spec)
    return out


def test_label_mapper_matches():
    for ignore in ((0, 1), (0,), ()):
        labels = dict(TransferConfig().labels)
        j = JS.LabelMapper.from_labels(labels, ignore_classes=ignore)
        t = TS.LabelMapper.from_labels(labels, ignore_classes=ignore)
        assert j.raw_ids == t.raw_ids
        assert j.ignore_indices == t.ignore_indices
        np.testing.assert_array_equal(j.raw_to_index, t.raw_to_index)
        raw = np.arange(-3, 300)
        np.testing.assert_array_equal(j.to_index(raw), t.to_index(raw))
        idx = np.arange(-2, t.num_classes + 3)
        np.testing.assert_array_equal(j.to_raw(idx), t.to_raw(idx))
    assert TS.MOVING_TO_STATIC == JS.MOVING_TO_STATIC


def test_frame_tensors_match(synthetic_dataset):
    """A frame's features, label indices and weights against the JAX
    trainer's (agreeing on >= 99.9 % of pixels: a point on a pixel
    boundary can move; features within 1e-4 m elsewhere)."""
    seq = kitti.KittiSequence.open(synthetic_dataset)
    spec = SensorSpec.from_yaml(os.path.join(synthetic_dataset,
                                             "config.yaml"))
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    jmapper = JS.LabelMapper.from_labels(dict(JTransferConfig().labels))
    for idx in range(len(seq)):
        f, l, w = (t.numpy() for t in TS._frame_tensors(
            seq, idx, spec, cap, MAPPER, torch.device("cpu")))
        jf, jl, jw = (np.asarray(a) for a in JS._frame_tensors(
            seq, idx, spec, cap, jmapper, None))
        same = (l == jl) & (w == jw) & np.all(
            np.abs(f - jf) <= 1e-4, axis=-1)
        assert same.mean() >= 0.999, (idx, same.mean())


def test_resumed_trainers_agree(runs):
    """Both trainers resume the JAX step-1 checkpoint to step 3: their
    parameters agree."""
    want = interop.rangenet_state_dict(runs["jax_params"], TCFG)
    got = runs["model"].state_dict()
    diff = torch.cat([(got[k] - v).abs().reshape(-1)
                      for k, v in want.items()])
    assert float(diff.max()) <= 2e-3, float(diff.max())
    assert float((diff <= 1e-4).float().mean()) >= 0.999
    blob = torch.load(runs["port3"], weights_only=False)
    assert blob["step"] == 3 and blob["sampling"] == runs["blob"]["sampling"]
    assert float(blob["optimizer"]["state"][0]["step"]) == 3.0


@pytest.mark.parametrize("knn", [False, True])
def test_write_predictions_agree(runs, synthetic_dataset, tmp_path, knn):
    """``write_predictions`` of the two resumed models on the same tree:
    the same files, uint32 raw ids of the mapper, and the same class on
    >= 99.9 % of points."""
    root = str(tmp_path / "pred")
    n = TS.write_predictions(synthetic_dataset, root, runs["model"],
                             runs["mapper"], runs["spec"], verbose=False,
                             knn=knn, batch=2)
    assert n == 5
    sub = os.path.join("sequences", "00", "predictions")
    names = sorted(os.listdir(os.path.join(root, sub)))
    assert names == sorted(os.listdir(os.path.join(runs[f"jax_pred_{knn}"],
                                                   sub)))
    agree = total = 0
    for name in names:
        got = np.fromfile(os.path.join(root, sub, name), np.uint32)
        want = np.fromfile(os.path.join(runs[f"jax_pred_{knn}"], sub, name),
                           np.uint32)
        assert got.shape == want.shape
        assert set(np.unique(got)) <= set(MAPPER.raw_ids)
        agree += int((got == want).sum())
        total += got.size
    assert agree / total >= 0.999, agree / total


def test_evaluate_semantics_equals_jax(runs, synthetic_dataset):
    """The port's evaluation (the confusion counts through ``IoUEval``) of
    the JAX predictions is JAX's dict."""
    got = TS.evaluate_semantics(synthetic_dataset, runs["jax_pred_False"],
                                device="cpu")
    assert got == runs["jax_eval"]
    assert got["scans"] == 5 and 10 in got["iou_per_class"]


def test_checkpoint_round_trip(runs, tmp_path):
    """A loaded checkpoint gives the saved model's logits bit for bit; a
    checkpoint without optimizer state loads for inference."""
    model, mapper, spec = TS.load_checkpoint(runs["port3"], "cpu")
    assert model.cfg == TCFG and mapper.raw_ids == MAPPER.raw_ids
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, spec.H, spec.W, 5)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model(x), runs["model"](x))
    bare = str(tmp_path / "bare.pt")
    TS.save_checkpoint(bare, model, mapper, spec)
    m2, _, _ = TS.load_checkpoint(bare, "cpu")
    with torch.no_grad():
        assert torch.equal(m2(x), model(x))


def test_resume_checks(runs, synthetic_dataset, tmp_path):
    """Resuming refuses a checkpoint without optimizer state, another
    model config and other sampling parameters (the replay would
    diverge)."""
    kw = dict(steps=4, model_cfg=TCFG, verbose=False, seed=SEED,
              device="cpu")
    model, mapper, spec = TS.load_checkpoint(runs["port1"], "cpu")
    bare = str(tmp_path / "bare.pt")
    TS.save_checkpoint(bare, model, mapper, spec)
    with pytest.raises(ValueError, match="opt_state"):
        TS.train_segmentation(synthetic_dataset, checkpoint_path=bare,
                              resume=True, **kw)
    for change, what in ((dict(batch_size=2), "sampling"),
                         (dict(seed=SEED + 1), "sampling"),
                         (dict(model_cfg=dataclasses.replace(
                             TCFG, stem_features=32)), "model config")):
        path = str(tmp_path / "c.pt")
        shutil.copy(runs["port1"], path)
        with pytest.raises(ValueError, match=what):
            TS.train_segmentation(synthetic_dataset, checkpoint_path=path,
                                  resume=True, **dict(kw, **change))


def test_resume_matches_straight_run(synthetic_dataset, tmp_path,
                                     monkeypatch):
    """Kill-and-resume reproduces the uninterrupted run exactly; the
    periodic checkpoints fire inside the loop (after steps 2 and 4, the
    final one at 5)."""
    kw = dict(model_cfg=TCFG, verbose=False, seed=3, device="cpu")
    straight, _, _ = TS.train_segmentation(synthetic_dataset, steps=5, **kw)
    saved = []
    real_save = TS.save_checkpoint

    def spy(path, model, mapper, spec, **skw):
        saved.append(skw.get("step"))
        real_save(path, model, mapper, spec, **skw)

    monkeypatch.setattr(TS, "save_checkpoint", spy)
    ckpt = str(tmp_path / "c.pt")
    TS.train_segmentation(synthetic_dataset, steps=5, checkpoint_path=ckpt,
                          checkpoint_every=2, **kw)
    assert saved == [2, 4, 5]
    shutil.copy(ckpt, ckpt + ".5")
    TS.train_segmentation(synthetic_dataset, steps=2, checkpoint_path=ckpt,
                          **kw)
    resumed, _, _ = TS.train_segmentation(
        synthetic_dataset, steps=5, checkpoint_path=ckpt, resume=True, **kw)
    for k, v in straight.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k


def test_entry_points_refuse_without_a_card(synthetic_dataset, tmp_path,
                                            monkeypatch, capsys):
    """With no CUDA device the default device raises (no CPU fallback),
    and each command exits 2 before doing anything; with a card,
    ``--device-parallel`` outside a torchrun job exits 2 and says so, and a
    device-parallel cell of another adaption than mergemesh raises."""
    import importlib

    gs = importlib.import_module(
        "lidar_transfer_tpu_torch.experiments.grid_search")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.train_segmentation(synthetic_dataset, steps=1, model_cfg=TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.evaluate_semantics(synthetic_dataset, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_transfer(synthetic_dataset, small_cfg())
    out = str(tmp_path / "m.pt")
    for argv in (["train", "-d", synthetic_dataset, "--tiny", "--out", out],
                 ["eval", "-d", synthetic_dataset, "-p", str(tmp_path)]):
        assert TS.main(argv) == 2
    assert TW.main(["real_on_real", "-d", synthetic_dataset]) == 2
    assert gs.main(["-d", synthetic_dataset]) == 2
    assert not os.path.exists(out)
    assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert gs.main(["-d", synthetic_dataset, "--device-parallel"]) == 2
    assert "torchrun" in capsys.readouterr().err
    with pytest.raises(ValueError, match="mergemesh only"):
        evaluate_transfer(synthetic_dataset, small_cfg(), mesh=object(),
                          device="cpu")


def test_cli_train_infer_eval(synthetic_dataset, tmp_path, capsys):
    """``lt-seg-torch train|infer|eval --device cpu``: a model file,
    predictions with kNN, a metrics JSON."""
    import json

    model = str(tmp_path / "m.pt")
    pred = str(tmp_path / "pred")
    mj = str(tmp_path / "m.json")
    assert TS.main(["train", "-d", synthetic_dataset, "--tiny", "--steps",
                    "2", "--out", model, "--device", "cpu"]) == 0
    assert TS.main(["infer", "-d", synthetic_dataset, "-m", model, "-p",
                    pred, "--knn", "--device", "cpu"]) == 0
    assert TS.main(["eval", "-d", synthetic_dataset, "-p", pred, "--json",
                    mj, "--device", "cpu"]) == 0
    with open(mj) as f:
        res = json.load(f)
    assert res["scans"] == 5 and 0.0 <= res["miou"] <= 1.0
    assert "5 scans inferred" in capsys.readouterr().out


def test_compare_datasets_equal_jax(synthetic_dataset, tmp_path):
    got = compare_datasets({"a": synthetic_dataset, "b": synthetic_dataset},
                           out_dir=str(tmp_path / "cmp"))
    want = j_compare_datasets({"a": synthetic_dataset,
                               "b": synthetic_dataset})
    assert got == want and sum(got["a"].values()) > 1000
    assert os.path.exists(tmp_path / "cmp" / "class_histograms.json")


def test_grid_search_cp_cell_equals_jax(synthetic_dataset, tmp_path):
    """A cp cell (the exact identity path on both sides) scores what the
    JAX cell scores; the grid writes its JSON and heat map."""
    import json

    cfg = small_cfg()
    want = j_evaluate_transfer(
        synthetic_dataset, JTransferConfig(**dataclasses.asdict(cfg)),
        frames=2)
    got = evaluate_transfer(synthetic_dataset, cfg, frames=2, device="cpu")
    assert got["frames"] == want["frames"] == 2
    for key in ("iou", "acc", "mse"):
        assert got[key] == want[key], key
    out = str(tmp_path / "grid")
    res = grid_search(synthetic_dataset, frames_list=[1, 2],
                      voxel_sizes=[0.25], adaption="cp", base_cfg=cfg,
                      out_dir=out, verbose=False, device="cpu")
    assert len(res["cells"]) == 2 and res["cells"][0]["iou"] == want["iou"]
    with open(os.path.join(out, "grid_search.json")) as f:
        assert json.load(f)["grid"]["frames_list"] == [1, 2]
    assert os.path.exists(os.path.join(out, "heatmap_iou.svg"))


def test_workflow_fake_on_real(synthetic_dataset, tmp_path):
    """``run_workflow`` makes the fake dataset through the port's CLI
    (mergemesh), trains on it and scores the real one, with kNN."""
    res = TW.run_workflow(
        "fake_on_real", synthetic_dataset, str(tmp_path / "wf"),
        small_cfg(adaption="mergemesh"), steps=2, knn=True, frames=2,
        model_cfg=TCFG, verbose=False, device="cpu")
    assert res["kind"] == "fake_on_real" and res["knn"] is True
    assert res["eval_dataset"] == synthetic_dataset
    assert 0.0 <= res["miou"] <= 1.0 and res["scans"] == 5
    fake = kitti.KittiSequence.open(res["train_dataset"])
    assert len(fake) == 2 and fake.read(0)[0].shape[0] > 100
    assert os.path.exists(os.path.join(res["train_dataset"], "config.yaml"))
