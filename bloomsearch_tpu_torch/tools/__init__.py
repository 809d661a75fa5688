"""Measurement tools of the port: the kernel-floor experiment, the kernel-build
timing, the dataset generators and the chained-launch timer they share."""
