"""``python -m quad_periodic_mpc_tpu_torch``: the command-line interface."""

from quad_periodic_mpc_tpu_torch.cli import main

if __name__ == "__main__":
    main()
