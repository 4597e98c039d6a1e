"""``idle_share.batched``'s reading, in the host-fed cell."""
from portbench.harness import load_reader

read = load_reader("idle_share.batched")
