"""``tracked_frames_per_s``'s reading, in the host-fed cell."""
from portbench.harness import load_reader

read = load_reader("tracked_frames_per_s")
