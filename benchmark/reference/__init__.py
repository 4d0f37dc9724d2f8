"""The plain reference the benchmark judges the program's replies by.

Plain NumPy and PyTorch only: nothing here imports the program (the
``tpu_joints_torch`` port) or the JAX package, and nothing takes what the
program made (its bank, working set or graphs). From the same depth frames
and the same CAD recipe the reference works out again what a reply claims:
the frame's working set, the CAD rows the fitness is taken over, the bank's
view poses and clouds, and from those the fitness and box at the reply's
own pose; the frame maker supplies the true pose and which pixels show the
joint.
"""
