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

The two kernels of the walk are written by hand for Hopper: upfirdn2d
in CUDA C++ (csrc/upfirdn2d.cu) and bias_act in Triton (ops/bias_act.py).
"""

__version__ = "0.1.0"
