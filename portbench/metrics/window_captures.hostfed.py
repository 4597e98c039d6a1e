"""``window_captures.batched``'s reading, in the host-fed cell."""
from portbench.harness import load_reader

read = load_reader("window_captures.batched")
