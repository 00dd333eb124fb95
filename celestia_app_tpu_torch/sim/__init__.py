"""The scenario plane: a virtual-time, seeded, in-process simulation
engine for tens of validators plus hundreds of DASer light nodes. The port
of celestia_app_tpu/sim: every validator's squares, commitments, provers
and every light node's repairs and fraud proofs run on the card (K1, K2)
unless the caller passes ``device="cpu"``.

- scheduler.py — the seeded discrete-event scheduler driving ONE
  VirtualClock (utils/clock.py): same seed ⇒ byte-identical event trace.
- engine.py — the world: SimTransport (a direct-call peer transport over
  the real das/server + header routes), SimValidator (an event-driven
  Tendermint round machine over chain/consensus.ValidatorNode),
  SimLightNode (a real das/daser.DASer swept on the virtual timeline),
  and Simulation, which wires them and computes verdict metrics.
- scenarios.py — the declarative adversarial scenario library (dict/JSON
  specs -> faults + topology ops) and ``run_scenario``.
"""

from celestia_app_tpu_torch.sim.scenarios import (  # noqa: F401
    SCENARIOS,
    run_scenario,
    scenario_spec,
)
from celestia_app_tpu_torch.sim.scheduler import Scheduler  # noqa: F401
