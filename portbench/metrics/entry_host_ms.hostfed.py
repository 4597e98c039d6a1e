"""``entry_host_ms.batched``'s reading, in the host-fed cell."""
from portbench.harness import load_reader

read = load_reader("entry_host_ms.batched")
