"""The harness's shared code: the run, the timed windows, the trace
reader and the helpers on trees of tensors."""
