"""Frozen operation and byte counts of the program's CUDA kernels, and the
H100's data-sheet peaks, from which the per-layer readers take each
kernel's share of its roofline. A later change to a kernel cannot change
its yardstick here."""
