"""Batch splitting and sweep runners (counterpart of
``quad_periodic_mpc_tpu/parallel/``): the batch axis is the MPC instance
(gait x phase x disturbance hypothesis x terrain scenario), split over a
list of devices in one process and over ranks through
``torch.distributed``."""
