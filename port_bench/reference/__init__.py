"""The plain reference of the benchmark: a frozen, pruned copy of the
PyTorch port's plain path for the two configurations the benchmark runs
(the SRB walking loop and the full torque stack), every hand-written
kernel replaced by its plain version.  Plain PyTorch; it imports nothing
of the program under test, and a later change to the program cannot move
it."""
