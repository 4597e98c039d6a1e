"""``warp_pool_roofline.batched``'s reading, in the host-fed cell."""
from portbench.harness import load_reader

read = load_reader("warp_pool_roofline.batched")
