"""One module per kind of configuration (``"stack"`` in its file): how the
program's timed units and the reference's are built from the cell's
inputs, and what the comparison reads."""
