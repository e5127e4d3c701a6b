"""Fleet serving in the port: N `GenerationSession` replicas behind one
router (port of easydist_tpu/fleet, which imports nothing of JAX; the
port keeps its own copies).

  * `FleetRouter` — admission-controlled submit routed by a scored policy
    (prefix-cache affinity + slot occupancy, breaker-aware eligibility,
    consistent-hash placement for cold prefixes), replica lifecycle
    (zero-downtime drain with hot-page migration in waves, immediate
    evacuate with bitwise-seamless mid-stream resubmission);
  * prefill/decode disaggregation — dedicated prefill replicas compute
    page-aligned prompt prefixes and hand committed KV pages to decode
    replicas through a `KVTransport`;
  * `InProcessTransport` — pages move by reference on their device, the
    sha256-per-page manifest still round-trips and is verified before
    commit;
  * `HashRing` — consistent hashing over sha256 virtual points, placing
    every key where the JAX package's ring places it;
  * `HealthMonitor`, `ResumeDescriptor`, `PoisonRequestError` — liveness
    probes, crash recovery from emitted ids, poison quarantine.

Fleet outputs equal a single session's: every replica runs the same
params and programs, prefix restore equals recompute, and greedy
continuation is a pure function of the token prefix.
"""

from .failover import PoisonRequestError, ResumeDescriptor  # noqa: F401
from .hashring import HashRing, prefix_hash_key  # noqa: F401
from .health import (ALIVE, DEAD, SUSPECT, HealthConfig,  # noqa: F401
                     HealthMonitor)
from .router import FleetConfig, FleetRouter, Replica  # noqa: F401
from .transport import (InProcessTransport, KVTransport,  # noqa: F401
                        PageCorruptError, TransportError,
                        TransportStallError, manifest_key, page_manifest,
                        verify_manifest)
