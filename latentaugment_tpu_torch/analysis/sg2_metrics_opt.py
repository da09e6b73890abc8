"""Tuning of the walk's loss weights by the precision/recall objective
(counterpart: latentaugment_tpu/analysis/sg2_metrics_opt.py). Each trial
(a) dumps n_imgs augmented images through the policy, (b) scores them
with FID and precision/recall per modality through the port's
`calc_metric`, on the policy's `--device`, (c) returns recall, precision
or F1 to the study; the dump is deleted after scoring. Optuna where it is
installed, else the built-in random-search study (hpo.py).

    python -m latentaugment_tpu_torch.analysis.sg2_metrics_opt <AugOptions arguments>

The study persists in ./optuna_study.pickle.
"""

import os
import pickle
import shutil

import numpy as np

from ..augments import create_augment
from ..data import create_dataset
from ..metrics import calc_metric
from ..options import AugOptions
from ..utils import util_general, util_io, util_path
from . import hpo

PARAM_SPACE = {
    "w_lpips": [0, 0.1, 0.3, 1, 3, 10],
    "w_pix": [0, 0.1, 0.3, 1, 3, 10],
    "w_latent": [0, 0.001, 0.003, 0.01, 0.03, 0.1],
    "w_disc": [0, 0.01, 0.03, 0.1, 0.3, 1],
    "opt_num_epochs": [3, 6, 9],
    "opt_lr": [0.001, 0.003, 0.01, 0.03, 0.1],
}


def dump_imgs(trial, n_imgs=10000, argv=None):
    """Suggest hyperparams, run the augment pipeline, dump img_aug pickles."""
    params = {name: trial.suggest_categorical(name, space)
              for name, space in PARAM_SPACE.items()}
    params.update({"p_thres": 0.0, "init_w": "inv", "n_imgs": n_imgs})

    opt = AugOptions().parse(args=params, argv=argv, install_logger=False)

    outdir = os.path.join(opt.checkpoints_dir, opt.name)
    util_path.create_dir(os.path.join(outdir, "img_aug"))

    dataset = create_dataset(opt)
    print("The number of training images = %d" % len(dataset))
    augment = create_augment(opt)

    n_iter = n_imgs // opt.batch_size
    for i, data in enumerate(dataset):
        if i >= n_iter:
            break
        augment.set_input(data)
        augment.forward()
        data_aug = augment.get_output()
        util_io.write_pickle(data_aug, os.path.join(outdir, "img_aug",
                                                    f"img_aug_{i}"))
    return opt


def calc_pr(opt, metrics_name=None, keep_dumps=False, eval_split="val"):
    """Score the dumped augmented set; returns (precision, recall) averaged
    over modalities; deletes the dump dir unless keep_dumps."""
    import json

    if metrics_name is None:
        metrics_name = ["fid50k_full", "pr50k3_full"]
    synthetic_dir = os.path.join(opt.checkpoints_dir, opt.name)
    modalities = util_general.parse_comma_separated_list(opt.modalities_aug)

    dataset_kwargs = dict(
        path=os.path.join(opt.interim_dir, opt.dataset_aug,
                          opt.dataset_name_aug + ".zip"),
        split=eval_split, modalities=modalities, resolution=opt.img_resolution)
    dataset_kwargs_gen = dict(dataroot=synthetic_dir, aug_name=opt.name,
                              batch_size=opt.batch_size)

    results = []
    for mode_idx, mode in enumerate(modalities):
        mode_dict = dict(mode_name=mode, mode_idx=mode_idx)
        for metric in metrics_name:
            res = calc_metric(metric, dataset_kwargs=dataset_kwargs,
                              dataset_kwargs_gen=dataset_kwargs_gen,
                              mode_dict=mode_dict, device=opt.device)
            results.append(dict(metric=metric, mode=mode,
                                value=dict(res.results)))

    with open(os.path.join(opt.checkpoints_dir, f"metric-{opt.name}.jsonl"),
              "at") as f:
        f.write(json.dumps({opt.name: results}, indent=3) + "\n")

    precision = np.mean([r["value"]["pr50k3_full_precision"]
                         for r in results if r["metric"] == "pr50k3_full"])
    recall = np.mean([r["value"]["pr50k3_full_recall"]
                      for r in results if r["metric"] == "pr50k3_full"])

    if not keep_dumps:
        shutil.rmtree(synthetic_dir, ignore_errors=True)
    return float(precision), float(recall)


def objective(trial, n_imgs=10000, argv=None):
    opt = dump_imgs(trial, n_imgs=n_imgs, argv=argv)
    precision, recall = calc_pr(opt)
    return 2 * (precision * recall) / max(precision + recall, 1e-12)


def objective_recall(trial, n_imgs=10000, argv=None, eval_split="val"):
    opt = dump_imgs(trial, n_imgs=n_imgs, argv=argv)
    _, recall = calc_pr(opt, eval_split=eval_split)
    return recall


def objective_precision(trial, n_imgs=10000, argv=None):
    opt = dump_imgs(trial, n_imgs=n_imgs, argv=argv)
    precision, _ = calc_pr(opt)
    return precision


def run_study(checkpoint_dir, objective_fn=objective_recall, n_trials=50,
              n_imgs=10000, argv=None):
    study_path = os.path.join(checkpoint_dir, "optuna_study.pickle")
    try:
        with open(study_path, "rb") as handle:
            study = pickle.load(handle)
        print("load study.")
    except FileNotFoundError:
        study = hpo.create_study(directions=["maximize"])
        print("create new study.")

    study.optimize(lambda t: objective_fn(t, n_imgs=n_imgs, argv=argv),
                   n_trials=n_trials)

    print(study.best_params)
    df = study.trials_dataframe(attrs=("number", "value", "params", "state"))
    try:
        df.to_excel(os.path.join(checkpoint_dir, "optuna_study.xlsx"))
    except (ImportError, ModuleNotFoundError):
        df.to_csv(os.path.join(checkpoint_dir, "optuna_study.csv"))
    with open(study_path, "wb") as handle:
        pickle.dump(study, handle, protocol=pickle.HIGHEST_PROTOCOL)
    return study


def load_stylegan(dir_model, exp_stylegan, network_pkl_stylegan):
    """Locate `<dir_model>/<*exp_stylegan*>/<network_pkl_stylegan>` and load
    it through the port's allow-list converter (native, NVIDIA and TF-era
    pickles): (g_params, g_cfg, d_params, d_cfg).
    """
    from ..models.stylegan2 import convert

    matches = [x for x in os.listdir(dir_model) if exp_stylegan in x]
    if len(matches) != 1:
        raise ValueError(f"expected exactly one run matching {exp_stylegan!r}, got {matches}")
    path = os.path.join(dir_model, matches[0], network_pkl_stylegan)
    print(f'Loading stylegan from "{path}"...')
    return convert.load_stylegan(path)


if __name__ == "__main__":
    import sys

    run_study(checkpoint_dir=".", argv=sys.argv[1:])
