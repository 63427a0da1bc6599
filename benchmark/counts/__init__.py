"""The benchmark's frozen yardstick: operation and byte counts and the
H100's peaks."""
