"""Ops of the walk. Import from the modules (`ops.bias_act.bias_act`,
`ops.upfirdn2d.upfirdn2d`, ...): re-exporting the functions here would
shadow the modules that hold the kernels' launch counters."""
