"""Native host runtime bindings (counterpart of
``quad_periodic_mpc_tpu/runtime``): the C++ periodic loop, shared-memory
ring, UDP robot bridge and safety filter, the rebuild of the reference's
LoopFunc / SharedMemory / unitree UDP tier."""
