"""``finalize_ms.closed``'s reading, in a cell whose rate is
``solves_per_s.host_paced`` (the host paces its waves)."""
from dgobench.spec import HERE, load_module

read = load_module(HERE / "metrics" / "finalize_ms.closed.py").read
