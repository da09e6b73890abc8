"""The port's dataset tools and loaders against the JAX package's, on the
same seeded numpy inputs.

Each scenario of tests/test_dataset_tool_front.py and tests/test_datasets.py
runs through both packages: arrays must be equal, and a zip the tools
write must equal the JAX tool's member by member (names and bytes). The
`random` module, which both packages draw crops, flips, augmentations
and sanity-picture picks from, is seeded alike before each side.
"""

import argparse
import builtins
import os
import pickle
import random
import shutil
import sys
import zipfile

import numpy as np
import pytest

from latentaugment_tpu.data import base_dataset as base_j
from latentaugment_tpu.data import create_csv_mayoclinic as csv_j
from latentaugment_tpu.data import dataset_tool as dt_j
from latentaugment_tpu.data import mayoclinic_dataset as mayo_j
from latentaugment_tpu.data import vce_dataset as vce_j
from latentaugment_tpu.data.pelvis_dataset import PelvisDataset as PelvisDataset_j
from latentaugment_tpu.options.base_options import str2bool as str2bool_j
from latentaugment_tpu.utils import util_io as util_io_j
from latentaugment_tpu_torch.data import base_dataset as base_t
from latentaugment_tpu_torch.data import create_csv_mayoclinic as csv_t
from latentaugment_tpu_torch.data import create_dataset as create_dataset_t
from latentaugment_tpu_torch.data import dataset_tool as dt_t
from latentaugment_tpu_torch.data import mayoclinic_dataset as mayo_t
from latentaugment_tpu_torch.data import vce_dataset as vce_t
from latentaugment_tpu_torch.data.pelvis_dataset import PelvisDataset as PelvisDataset_t
from latentaugment_tpu_torch.options.base_options import str2bool as str2bool_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

MODES = ("MR_nonrigid_CT", "MR_MR_T2")


def _opt(**kw):
    return argparse.Namespace(**kw)


def _equal(got, want):
    """Equal arrays of one dtype, or equal trees of them."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (type(got), want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _both(fn_j, fn_t, seed=0):
    """(JAX result, port result) of two calls, `random` seeded alike."""
    random.seed(seed)
    np.random.seed(seed)
    want = fn_j()
    random.seed(seed)
    np.random.seed(seed)
    return want, fn_t()


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _same_zip(a, b):
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        assert za.namelist(), "empty zip"
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name


def _same_pickle_tree(a, b):
    files = _tree_files(a)
    assert files == _tree_files(b) and files
    for f in files:
        _equal(util_io_j.read_pickle(os.path.join(b, f)),
               util_io_j.read_pickle(os.path.join(a, f)))


# ----------------------------------------------------------------------------
# dataset_tool: the front half


class _FakeDicomSlice:
    def __init__(self, pixels, z=None, instance=None, slope=1.0, intercept=0.0):
        self.pixel_array = pixels
        if z is not None:
            self.ImagePositionPatient = [0.0, 0.0, float(z)]
        if instance is not None:
            self.InstanceNumber = instance
        self.RescaleSlope = slope
        self.RescaleIntercept = intercept


@pytest.mark.parametrize("order", ["position", "instance_number"])
def test_assemble_dicom_series_matches_jax(order):
    rs = np.random.RandomState(0)
    planes = [rs.randint(0, 100, (8, 8)).astype(np.int16) for _ in range(4)]
    if order == "position":
        slices = [_FakeDicomSlice(planes[i], z=[30, 10, 40, 20][i], slope=2.0,
                                  intercept=-1000.0) for i in range(4)]
    else:
        slices = [_FakeDicomSlice(planes[i], instance=[3, 1, 4, 2][i]) for i in range(4)]
    want = dt_j.assemble_dicom_series(slices)
    _equal(dt_t.assemble_dicom_series(slices), want)
    assert want.shape == (4, 8, 8)


def test_convert_dicom_2_nifti_needs_pydicom():
    try:
        import pydicom  # noqa: F401

        pytest.skip("pydicom is installed: the gate does not apply")
    except ImportError:
        pass
    for dt in (dt_j, dt_t):
        with pytest.raises(ImportError, match="pydicom"):
            dt.convert_dicom_2_nifti("/nonexistent", "/nonexistent", ["CT"])


@pytest.mark.parametrize("interpolation,shape", [("linear", (16, 16)), ("nearest", (4, 4)),
                                                 ("cubic", (12, 20))])
def test_resize_volume_matches_jax(interpolation, shape):
    vol = np.zeros((2, 8, 8))
    vol[:, 2:6, 2:6] = 1.0
    vol += np.random.RandomState(1).rand(2, 8, 8) * 0.1
    want = dt_j.resize_volume(vol, shape, interpolation=interpolation)
    _equal(dt_t.resize_volume(vol, shape, interpolation=interpolation), want)
    assert want.shape == (2, *shape)


def test_resize_folder_matches_jax(tmp_path):
    for p in ("patient001", "patient002"):
        src = tmp_path / "vols" / p
        os.makedirs(src)
        np.save(src / "MR_nonrigid_CT.npy", np.random.RandomState(0).rand(3, 8, 8))
        np.save(src / "MR_MR_T2.npy", np.random.RandomState(1).rand(3, 8, 8))
    done = {}
    for name, dt in (("j", dt_j), ("t", dt_t)):
        done[name] = dt.resize_nifti_folder(str(tmp_path / "vols"), str(tmp_path / name),
                                            (16, 16))
    assert done["t"] == done["j"] == ["patient001", "patient002"]
    files = _tree_files(tmp_path / "j")
    assert files == _tree_files(tmp_path / "t") and len(files) == 4
    for f in files:
        _equal(np.load(tmp_path / "t" / f), np.load(tmp_path / "j" / f))


def test_region_helpers_match_jax():
    m = np.zeros((10, 10), np.uint8)
    m[1:5, 1:5] = 1   # 16 px blob
    m[8:10, 8:10] = 1  # 4 px blob
    big = dt_j.get_largest_connected_region(m)
    _equal(dt_t.get_largest_connected_region(m), big)
    assert big[2, 2] == 1 and big[9, 9] == 0
    cleaned = dt_j.remove_small_regions(m.copy(), min_size=10)
    _equal(dt_t.remove_small_regions(m.copy(), min_size=10), cleaned)
    assert cleaned[2, 2] == 1 and cleaned[9, 9] == 0


def test_intensity_mask_matches_jax():
    rs = np.random.RandomState(0)
    vol = rs.normal(5.0, 1.0, (4, 32, 32))
    vol[:, 8:24, 8:24] = rs.normal(120.0, 5.0, (4, 16, 16))
    m = dt_j.compute_intensity_mask(vol)
    _equal(dt_t.compute_intensity_mask(vol), m)
    assert m[:, 16, 16].all() and not m[:, 2, 2].any()


@pytest.mark.parametrize("dataset", ["Pelvis_2.1", "spleen", "heart", "kits19"])
def test_build_mask_volume_matches_jax(dataset):
    rs = np.random.RandomState(1)
    vol = rs.normal(1.0, 0.5, (3, 32, 32))
    vol[:, 10:22, 10:22] = rs.normal(150.0, 10.0, (3, 12, 12))
    m = dt_j.build_mask_volume(vol, dataset)
    _equal(dt_t.build_mask_volume(vol, dataset), m)
    assert m[:, 16, 16].all()
    assert dt_t.mask_reference_modality(dataset) == dt_j.mask_reference_modality(dataset)


def _raw_pelvis(root, n_patients=3, depth=8, size=13):
    rs = np.random.RandomState(0)
    for i in range(n_patients):
        pdir = os.path.join(root, f"patient{i + 1:03d}")
        os.makedirs(pdir)
        base = rs.rand(depth, size, size) * 1500.0  # odd in-plane size
        np.save(os.path.join(pdir, "MR_nonrigid_CT.npy"), base)
        np.save(os.path.join(pdir, "MR_MR_T2.npy"), base * 0.5 + 10.0)
    return root


@pytest.fixture(scope="module")
def pelvis(tmp_path_factory):
    """prepare_pelvis_2_1 of both packages on one set of raw volumes."""
    root = tmp_path_factory.mktemp("pelvis")
    raw = _raw_pelvis(str(root / "raw"))
    out = {}
    for name, dt in (("j", dt_j), ("t", dt_t)):
        random.seed(3)
        out[name] = dt.prepare_pelvis_2_1(
            raw, str(root / f"interim_{name}"), str(root / f"pelvis_{name}.zip"),
            image_shape=(16, 16), pop_range=2, apply_mask=True, splits=(0.4, 0.3, 0.3), seed=0)
    return dict(root=root, **out)


def test_prepare_pelvis_zip_equals_jax(pelvis):
    (zip_j, splits_j), (zip_t, splits_t) = pelvis["j"], pelvis["t"]
    assert splits_t == splits_j
    assert sorted(sum(splits_t.values(), [])) == ["patient001", "patient002", "patient003"]
    _same_zip(zip_t, zip_j)
    with zipfile.ZipFile(zip_t) as zf:
        assert len(zf.namelist()) == 12  # 8 slices - 2 * pop_range, 3 patients


@pytest.mark.parametrize("stage", ["nifti_resized", "nifti_normalized", "nifti_mask", "pickles"])
def test_prepare_pelvis_interim_products_equal_jax(pelvis, stage):
    a = os.path.join(pelvis["root"], "interim_j", stage)
    b = os.path.join(pelvis["root"], "interim_t", stage)
    files = _tree_files(a)
    assert files == _tree_files(b) and files
    for f in files:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npy"):
            _equal(np.load(pb), np.load(pa))
        elif f.endswith(".pickle"):
            _equal(util_io_j.read_pickle(pb), util_io_j.read_pickle(pa))


def test_ports_loaders_read_the_tools_zip(pelvis):
    from latentaugment_tpu_torch.augments.manifold import ImgDataset
    from latentaugment_tpu_torch.models.stylegan2.dataset import CustomImageFolderDataset

    zip_t, splits = pelvis["t"]
    split = next(s for s, ps in splits.items() if ps)
    img, fname = ImgDataset(path=zip_t, modalities=list(MODES), split=split, resolution=16)[0]
    assert img.shape == (2, 16, 16) and np.isfinite(img).all()
    ds = PelvisDataset_t(_opt(dataroot=zip_t, modalities=",".join(MODES), phase=split,
                              load_size=16))
    want = PelvisDataset_j(_opt(dataroot=zip_t, modalities=",".join(MODES), phase=split,
                                load_size=16))
    assert ds.AB_paths == want.AB_paths
    _equal(ds[0], want[0])
    folder = CustomImageFolderDataset(zip_t, modalities=list(MODES), split=split,
                                      resolution=16)
    assert len(folder) == len(ds)


# ----------------------------------------------------------------------------
# dataset_tool: the TIFF pipeline and the claro recipe


def _claro(root, n_patients=2, n_slices=3, size=20):
    from PIL import Image

    rs = np.random.RandomState(7)
    raw, interim = os.path.join(root, "raw"), os.path.join(root, "interim")
    os.makedirs(os.path.join(interim, "bootstrap", "folds"))
    rows = ["img label"]
    for p in range(n_patients):
        patient = f"claro{p:03d}"
        os.makedirs(os.path.join(raw, patient))
        for s in range(n_slices):
            hu = rs.rand(size, size) * 2400.0 - 1200.0
            Image.fromarray(hu.astype(np.float32)).save(
                os.path.join(raw, patient, f"{patient}_{s:05d}.tif"), "tiff")
            rows.append(f"{patient}/{patient}_{s:05d}.tif {p % 2}")
    with open(os.path.join(interim, "bootstrap", "folds", "all.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return raw, interim


def test_tiff_slice_helpers_match_jax():
    img = np.array([[-2000.0, 0.0], [500.0, 3000.0]])
    kw = dict(resolution=2, clip={"min": -1000, "max": 1000}, scale={"min": -1000, "max": 1000},
              scale_by_255=True)
    want = dt_j.transform_tiff_slice(img, **kw)
    _equal(dt_t.transform_tiff_slice(img, **kw), want)
    np.testing.assert_allclose(want, [[0.0, 127.5], [191.25, 255.0]])
    big = np.random.RandomState(2).rand(24, 24) * 3000 - 1000
    for kw in (dict(resolution=16, box=[2, 3, 20, 18], convert_to_uint8=True),
               dict(resolution=16, box=[2, 3, 20, 18], box_value="-7", scale_by_255=False)):
        _equal(dt_t.transform_tiff_slice(big, **kw), dt_j.transform_tiff_slice(big, **kw))
    sq = np.arange(16, dtype=np.float64).reshape(4, 4) + 5.0
    for value in ("min", "-7"):
        _equal(dt_t.apply_box_to_slice(sq, [1, 1, 3, 3], box_value=value),
               dt_j.apply_box_to_slice(sq, [1, 1, 3, 3], box_value=value))


def test_process_tiff_matches_jax(tmp_path):
    raw, interim = _claro(str(tmp_path))
    boxdir = tmp_path / "boxes"
    os.makedirs(boxdir)
    (boxdir / "boxes.json").write_text('{"claro000": [2, 2, 18, 18]}')
    kw = dict(source=raw, source_interim=interim, source_box=str(boxdir), dataset="claro",
              resolution=16, box_value="min", clip={"min": -1000, "max": 1000},
              scale={"min": -1000, "max": 1000}, convert_to_uint8=False, scale_by_255=True,
              sanity_check_prob=0.5)
    temp_j, temp_t = _both(lambda: dt_j.process_tiff(dest=str(tmp_path / "j"), **kw),
                           lambda: dt_t.process_tiff(dest=str(tmp_path / "t"), **kw), seed=1)
    _same_pickle_tree(temp_j, temp_t)
    assert len(_tree_files(temp_t)) == 6
    # The same slices got sanity pictures.
    assert (_tree_files(tmp_path / "t" / "sanity_check")
            == _tree_files(tmp_path / "j" / "sanity_check"))


def test_process_tiff_refuses_a_non_power_of_two(tmp_path):
    raw, interim = _claro(str(tmp_path), n_patients=1, n_slices=1)
    with pytest.raises(dt_t.DatasetToolError, match="power-of-two"):
        dt_t.process_tiff(source=raw, source_interim=interim, source_box=None,
                          dest=str(tmp_path / "out"), dataset="claro", resolution=20,
                          box_value="min", clip=None, scale=None, convert_to_uint8=False,
                          scale_by_255=True)
    # The command line reports it and exits 1.
    assert dt_t.main(["process_tiff", "--source", raw, "--source_interim", interim,
                      "--dest", str(tmp_path / "cli"), "--resolution", "20"]) == 1


_CLARO_CFG = {"data": {
    "resolution": 16,
    "modes": {"CT": {"clip": {"min": -1000, "max": 1000}, "scale": {"min": -1000, "max": 1000}}},
    "options": {"apply_box": False, "box_value": "min", "transpose_img": False,
                "convert_to_uint8": False, "scale_by_255": True},
    "validation": {"name": "hold_out", "split": [0.5, 0.5, 0.0], "n_exp": 1}}}


def _run_both(argv_of, tmp_path, seed=0):
    """The `run` subcommand of both tools (JAX: click, port: argparse)
    with per-package argv; returns nothing, asserts both succeeded."""
    from click.testing import CliRunner

    random.seed(seed)
    r = CliRunner().invoke(dt_j.main, argv_of("j"))
    assert r.exit_code == 0, r.output
    random.seed(seed)
    assert dt_t.main(argv_of("t")) == 0


def test_run_claro_steps_match_jax(tmp_path):
    import yaml

    raw, interim_src = _claro(str(tmp_path))
    cfg_file = tmp_path / "claro.yaml"
    cfg_file.write_text(yaml.safe_dump(_CLARO_CFG))
    for name in ("j", "t"):
        os.makedirs(tmp_path / name / "claro" / "bootstrap" / "folds")
        shutil.copy(os.path.join(interim_src, "bootstrap", "folds", "all.txt"),
                    tmp_path / name / "claro" / "bootstrap" / "folds" / "all.txt")

    def argv(step, data_dir):
        return lambda name: ["run", "--configuration_file", str(cfg_file),
                             "--data_dir", data_dir(name), "--interim_dir",
                             str(tmp_path / name), "--reports_dir", str(tmp_path / "rep" / name),
                             "--dataset", "claro", "--processing_step", step]

    _run_both(argv("process_tiff", lambda name: raw), tmp_path)
    _same_pickle_tree(str(tmp_path / "j" / "claro" / "temp"), str(tmp_path / "t" / "claro" / "temp"))
    _run_both(argv("snap_zip", lambda name: str(tmp_path / name / "claro")), tmp_path)
    zips = {n: [f for f in os.listdir(tmp_path / n / "claro") if f.endswith(".zip")]
            for n in ("j", "t")}
    assert zips["t"] == zips["j"] and len(zips["t"]) == 1 and zips["t"][0].startswith("claro-num-")
    _same_zip(str(tmp_path / "t" / "claro" / zips["t"][0]),
              str(tmp_path / "j" / "claro" / zips["j"][0]))


def test_run_pelvis_steps_on_npy_match_jax(tmp_path):
    """Every Pelvis_2.1 step of `run` on .npy volumes, chained as the
    recipe chains them; each step's products equal the JAX tool's."""
    import yaml

    raw = _raw_pelvis(str(tmp_path / "raw"), n_patients=2, depth=6)
    cfg = {"data": {"resolution": 16, "modes": {"MR_nonrigid_CT": {"upper_percentile": 99},
                                                 "MR_MR_T2": {"range": {"min": 0, "max": 800}}},
                    "options": {"pop_range": 1, "apply_mask": True},
                    "validation": {"name": "hold_out", "split": [0.5, 0.5, 0.0], "n_exp": 1}}}
    cfg_file = tmp_path / "pelvis.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg))
    out = lambda name, *p: str(tmp_path.joinpath(name, "Pelvis_2.1", *p))  # noqa: E731
    steps = [("process_nifti_resized", lambda n: raw, "nifti_volumes_16x16"),
             ("process_nifti_normalized", lambda n: out(n, "nifti_volumes_16x16"),
              "nifti_volumes_16x16_normalized"),
             ("mask_nifti", lambda n: out(n, "nifti_volumes_16x16_normalized"),
              "nifti_volumes_16x16_mask"),
             ("snap_pickle", lambda n: out(n, "nifti_volumes_16x16_normalized"), "temp"),
             ("snap_zip", lambda n: out(n), None)]
    for step, data_dir, product in steps:
        def argv(name, step=step, data_dir=data_dir):
            extra = (["--data_dir_mask", out(name, "nifti_volumes_16x16_mask")]
                     if step == "snap_pickle" else [])
            return ["run", "--configuration_file", str(cfg_file), "--data_dir", data_dir(name),
                    "--interim_dir", str(tmp_path / name), "--reports_dir",
                    str(tmp_path / "rep" / name), "--dataset", "Pelvis_2.1",
                    "--processing_step", step, *extra]

        _run_both(argv, tmp_path)
        if product is None:
            continue
        files = _tree_files(out("j", product))
        assert files == _tree_files(out("t", product)) and files, step
        for f in files:
            a, b = out("j", product, f), out("t", product, f)
            if f.endswith(".npy"):
                _equal(np.load(b), np.load(a))
            elif f.endswith(".pickle"):
                _equal(util_io_j.read_pickle(b), util_io_j.read_pickle(a))
    zips = sorted(f for f in os.listdir(out("t")) if f.endswith(".zip"))
    assert zips == sorted(f for f in os.listdir(out("j")) if f.endswith(".zip")) == [
        "Pelvis_2.1-num-000002.zip"]
    _same_zip(out("t", zips[0]), out("j", zips[0]))
    # process_dicom_2_nifti is the one step that needs more than numpy.
    with pytest.raises(ImportError, match="pydicom"):
        dt_t.main(["run", "--configuration_file", str(cfg_file), "--data_dir", raw,
                   "--interim_dir", str(tmp_path / "t"), "--reports_dir", str(tmp_path / "r"),
                   "--dataset", "Pelvis_2.1", "--processing_step", "process_dicom_2_nifti"])


def test_subcommands_options_and_steps_are_the_jax_tools():
    assert dt_t.REFERENCE_STEPS == dt_j.REFERENCE_STEPS
    sub = next(a for a in dt_t._parser()._actions if isinstance(a, argparse._SubParsersAction))
    assert sorted(sub.choices) == sorted(dt_j.main.commands)
    for name, cmd in dt_j.main.commands.items():
        port = {a.dest: a for a in sub.choices[name]._actions if a.dest != "help"}
        assert sorted(port) == sorted(p.name for p in cmd.params), name
        for p in cmd.params:
            a = port[p.name]
            assert a.option_strings == p.opts and a.required == p.required, (name, p.name)
            if p.required:
                continue
            assert a.default == p.default, (name, p.name)
            if getattr(p, "is_flag", False):
                assert isinstance(a, argparse._StoreTrueAction), (name, p.name)


def test_snap_zip_and_snap_pickle_commands_match_jax(tmp_path):
    from click.testing import CliRunner

    raw = _raw_pelvis(str(tmp_path / "raw"), n_patients=3, depth=4, size=16)
    for name in ("j", "t"):
        argv = ["snap-pickle", "--source", raw, "--dest", str(tmp_path / name / "pk"),
                "--pop_range", "1"]
        random.seed(5)
        if name == "j":
            assert CliRunner().invoke(dt_j.main, argv).exit_code == 0
        else:
            assert dt_t.main(argv) == 0
        argv = ["snap-zip", "--temp_dir", str(tmp_path / name / "pk" / "temp"), "--dest_zip",
                str(tmp_path / name / "out.zip"), "--seed", "3"]
        if name == "j":
            assert CliRunner().invoke(dt_j.main, argv).exit_code == 0
        else:
            assert dt_t.main(argv) == 0
    _same_zip(str(tmp_path / "t" / "out.zip"), str(tmp_path / "j" / "out.zip"))
    assert ((tmp_path / "t" / "out_splits.json").read_text()
            == (tmp_path / "j" / "out_splits.json").read_text())


def test_run_without_yaml_raises_a_clear_import_error(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ImportError, match="yaml"):
        dt_t.main(["run", "--configuration_file", str(tmp_path / "c.yaml"), "--data_dir", "x",
                   "--interim_dir", str(tmp_path), "--reports_dir", str(tmp_path),
                   "--dataset", "claro", "--processing_step", "snap_zip"])


# ----------------------------------------------------------------------------
# The loaders


def _mayo_files(tmp_path):
    rng = np.random.RandomState(5)
    root = tmp_path / "mayo"
    for i in range(3):
        for dom in ("full_dose_HD", "quarter_dose_LD"):
            d = root / f"L{i:03d}" / dom
            os.makedirs(d)
            for s in range(2):
                np.save(d / f"slice_{s}.npy", rng.rand(32, 32).astype(np.float32) * 3000 - 1000)
    return root


def test_create_csv_mayoclinic_writes_the_jax_files(tmp_path):
    root = _mayo_files(tmp_path)
    outs_j = csv_j.create_annotation_file(str(root), str(tmp_path / "j"), seed=3)
    csv_t.main(["--root", str(root), "--dest_dir", str(tmp_path / "t"), "--seed", "3"])
    for split, path in outs_j.items():
        with open(path) as a, open(tmp_path / "t" / os.path.basename(path)) as b:
            assert b.read() == a.read(), split


@pytest.fixture(scope="module")
def mayo_csv(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mayo")
    root = _mayo_files(tmp)
    return csv_t.create_annotation_file(str(root), str(tmp / "csv"), train=1.0, val=0.0,
                                        test=0.0)["train"]


def _mayo_opt(csv, **kw):
    return _opt(dataroot=csv, modalities="HD,LD", lower=-1000, upper=2000, img_shape=16,
                plot_verbose=False, model_name="pix2pix", **kw)


def test_mayoclinic_items_match_jax(mayo_csv):
    ds_j, ds_t = mayo_j.MayoClinicDataset(_mayo_opt(mayo_csv)), \
        mayo_t.MayoClinicDataset(_mayo_opt(mayo_csv))
    assert len(ds_t) == len(ds_j) == 6
    for i in range(len(ds_j)):
        _equal(ds_t[i], ds_j[i])
    x = np.array([-2000.0, -1000.0, 500.0, 2000.0, 3000.0])
    _equal(mayo_t.normalize_img(mayo_t.clip_img(x, -1000, 2000), -1000, 2000),
           mayo_j.normalize_img(mayo_j.clip_img(x, -1000, 2000), -1000, 2000))
    item = ds_t[0]
    assert item["A"].shape == (1, 16, 16) and -1.0 <= item["A"].min() <= item["A"].max() <= 1.0


def _vce_files(tmp_path):
    import pandas as pd

    rng = np.random.RandomState(5)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rows = []
    for i, (side, shape) in enumerate([("R", (40, 30)), ("L", (40, 30)), ("R", (30, 40))]):
        np.save(img_dir / f"le_{i}.npy", rng.rand(*shape).astype(np.float32) * 4000)
        np.save(img_dir / f"des_{i}.npy", rng.rand(*shape).astype(np.float32) * 4000)
        rows.append(dict(img_x=f"le_{i}.npy", img_y=f"des_{i}.npy", r_l=side,
                         wc_x=2000, ww_x=2000, wc_y=1800.5, ww_y=2500))
    csv = tmp_path / "ann.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return img_dir, csv


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_vce_items_match_jax(tmp_path, augment):
    img_dir, csv = _vce_files(tmp_path)
    opt = dict(dataroot=str(csv), modalities="LE,DES", model_name="pix2pix", img_dim=32,
               img_dir=str(img_dir), annotations_csv=str(csv), do_augmentation=augment,
               phase="train")
    ds_j, ds_t = vce_j.VCEDataset(_opt(**opt)), vce_t.VCEDataset(_opt(**opt))
    assert len(ds_t) == len(ds_j) == 3
    for seed in range(4 if augment else 1):
        for i in range(3):
            want, got = _both(lambda: ds_j[i], lambda: ds_t[i], seed=seed)
            _equal(got, want)
    assert got["A"].shape == (1, 32, 32) and 0.0 <= got["A"].min() <= got["A"].max() <= 1.0


def test_vce_pad_and_zoom_match_jax():
    img = np.random.RandomState(5).rand(40, 30).astype(np.float32)
    for side in ("R", "L"):
        _equal(vce_t.pad(img, side), vce_j.pad(img, side))
    for zoom in (0.9, 1.1):
        _equal(vce_t.clipped_zoom(img[:30], zoom), vce_j.clipped_zoom(img[:30], zoom))


@pytest.mark.parametrize("mode", ["mayoclinic", "vce"])
def test_create_dataset_finds_the_loader(tmp_path, mayo_csv, mode):
    common = dict(batch_size=2, serial_batches=True, max_dataset_size=float("inf"),
                  prefetch_batches=0, dataset_mode=mode, phase="train")
    if mode == "mayoclinic":
        opt, cls = _mayo_opt(mayo_csv, **common), mayo_j.MayoClinicDataset
    else:
        img_dir, csv = _vce_files(tmp_path)
        opt = _opt(dataroot=str(csv), modalities="LE,DES", model_name="pix2pix", img_dim=16,
                   img_dir=str(img_dir), annotations_csv=str(csv), do_augmentation=False,
                   **common)
        cls = vce_j.VCEDataset
    loader = create_dataset_t(opt)
    batch = next(iter(loader))
    ref = cls(opt)
    _equal(batch["A"], np.stack([ref[0]["A"], ref[1]["A"]]))
    _equal(batch["B_paths"], [ref[0]["B_paths"], ref[1]["B_paths"]])


@pytest.mark.parametrize("opt", [
    dict(preprocess="resize_and_crop", load_size=32, crop_size=16, no_flip=True),
    dict(preprocess="scale_width_and_crop", load_size=24, crop_size=16),
    dict(preprocess="crop", load_size=64, crop_size=20),
    dict(preprocess="none", load_size=16, crop_size=16)], ids=lambda o: o["preprocess"])
def test_base_dataset_transforms_match_jax(opt):
    img = (np.random.RandomState(5).rand(64, 48) * 255).astype(np.uint8)
    for with_params in (True, False):
        def run(base):
            o = _opt(**opt)
            params = base.get_params(o, (48, 64)) if with_params else None
            return params, base.get_transform(o, params)(img)
        (params_j, want), (params_t, got) = _both(lambda: run(base_j), lambda: run(base_t), 4)
        assert params_t == params_j
        _equal(got, want)
    assert want.dtype == np.float32 and -1.0 <= want.min() <= want.max() <= 1.0


def test_base_dataset_flip_default_on_and_grayscale():
    opt = _opt(preprocess="none", load_size=16, crop_size=16)
    img = np.arange(16 * 16, dtype=np.float32).reshape(16, 16)
    params = {"crop_pos": (0, 0), "flip": True}
    got = base_t.get_transform(opt, params=params, convert=False)(img)
    _equal(np.asarray(got), np.asarray(base_j.get_transform(opt, params=params, convert=False)(img)))
    np.testing.assert_array_equal(np.asarray(got), img[:, ::-1])
    rgb = (np.random.RandomState(1).rand(16, 16, 3) * 255).astype(np.uint8)
    _equal(base_t.get_transform(opt, params=params, grayscale=True)(rgb),
           base_j.get_transform(opt, params=params, grayscale=True)(rgb))


def test_str2bool_matches_jax():
    for v in ("False", "0", "no", "True", "yes", "1", True, False):
        assert str2bool_t(v) is str2bool_j(v)
    for f in (str2bool_t, str2bool_j):
        with pytest.raises(argparse.ArgumentTypeError):
            f("maybe")


def test_pelvis_split_is_the_leading_component(tmp_path):
    rng = np.random.RandomState(5)
    sl = {m: (rng.rand(8, 8) * 255).astype(np.float32) for m in MODES}
    zp = tmp_path / "pelvis.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("train/patient001/patient001_00000.pickle", pickle.dumps(sl))
        zf.writestr("val/trainor002/trainor002_00000.pickle", pickle.dumps(sl))
    opt = _opt(dataroot=str(zp), modalities=",".join(MODES), phase="train", load_size=8)
    ds_t, ds_j = PelvisDataset_t(opt), PelvisDataset_j(opt)
    assert [p.split("/")[0] for p in ds_t.AB_paths] == ["train"]
    _equal(ds_t[0], ds_j[0])


def test_pix2pix_example_trains_on_a_mayoclinic_set(tmp_path, mayo_csv):
    """The Mayo Clinic pairs (two files per pair, which the augment
    policies refuse) through the pix2pix example's baseline."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from examples.torch_train_pix2pix import main as pix2pix_main

    nets, history = pix2pix_main([
        "--no_augment", "--dataroot", mayo_csv, "--dataset_mode", "mayoclinic",
        "--img_shape", "16", "--batch_size", "2", "--pix2pix_steps", "2", "--device", "cpu",
        "--checkpoints_dir", str(tmp_path), "--aug", "latent", "--model_dir", "unused",
        "--interim_dir", "unused"])
    assert len(history) == 2
    assert all(np.isfinite(h[k]) for h in history for k in ("loss_G", "loss_D", "loss_L1"))
    with pytest.raises(ValueError, match="paths differ"):
        pix2pix_main(["--dataroot", mayo_csv, "--dataset_mode", "mayoclinic", "--img_shape", "16",
                      "--batch_size", "2", "--pix2pix_steps", "1", "--device", "cpu",
                      "--aug", "geometric", "--checkpoints_dir", str(tmp_path)])
