"""LatentAugment on PyTorch and CUDA: the port of `latentaugment_tpu`
(JAX on a TPU) to one NVIDIA H100. It imports torch and never jax.

Public API, as the JAX package's:

    from latentaugment_tpu_torch.options import AugOptions
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.augments import create_augment

    opt = AugOptions().parse()
    dataset = create_dataset(opt)
    augment = create_augment(opt)
    for data in dataset:
        augment.set_input(data)
        augment.forward()
        out = augment.get_output()

`--aug latent` is the LatentAugment walk, `--aug geometric` the classical
policy. Beside them: the projector that makes the walk's w codes
(models/stylegan2/projector.py, scripts/torch_project_dataset.py), the
perceptual criteria (augments/criteria) and the FID / precision-recall
metrics (metrics/).

Three kernels are written by hand for Hopper: upfirdn2d and StyleGAN3's
filtered_lrelu in CUDA C++ (csrc/) and bias_act in Triton (ops/bias_act.py).
"""

__version__ = "0.1.0"
