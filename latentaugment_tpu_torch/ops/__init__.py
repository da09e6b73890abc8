"""Ops of the walk. Import from the modules (`ops.bias_act.bias_act`,
`ops.upfirdn2d.upfirdn2d`, ...): re-exporting the functions here would
shadow the modules that hold the kernels' launch counters.

Importing this package registers the kernels' custom ops
(`latentaugment_torch::bias_act_fwd`, `::bias_act_bwd`, `::upfirdn2d`,
`::filtered_lrelu_fwd`, `::filtered_lrelu_bwd`), which a program saved
by `torch.export` calls: loading one needs this package imported. The
kernels themselves are built at their first launch on the card."""

from . import bias_act, filtered_lrelu, upfirdn2d  # noqa: F401 (register the custom ops)
