"""One HA control-plane replica of the port, for tests/test_torch_ha_replicas.py.

The counterpart of ``tests/ha_worker.py``: where that one wraps the
reference's ``HAController`` around a JobServer itself, this one runs the
port's user entry point, ``cli start-jobserver --device cpu`` with
``HARMONY_HA_LOG_DIR`` set (``cli._cmd_start_jobserver_ha``): it stands by on
the submit port (NOT_LEADER with a redirect), contends on the shared lease in
``ha_dir``, and on winning it replays the durable job log, re-arms the
in-flight submissions from their chains and serves. A fault plan rides
``HARMONY_FAULT_PLAN`` into the process, so a ``crash`` rule at
``worker.step`` kills the LEADER mid-epoch, for real, at a deterministic step.
torch runs one intra-op thread (the suite runs beside other workers).

Usage: python torch_ha_worker.py <ha_dir> <replica_id> <submit_port> <lease_s>
           <chkp_root>

The CLI prints ``HA replica <id> standing by on port N`` and, on takeover,
``HA replica <id> is LEADER on port N (...)``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ha_dir, replica_id, submit_port, lease_s, chkp_root = sys.argv[1:6]
    os.environ["HARMONY_HA_LOG_DIR"] = ha_dir
    os.environ["HARMONY_HA_LEASE_S"] = lease_s

    import torch

    torch.set_num_threads(1)
    from harmony_tpu_torch import cli

    return cli.main(["start-jobserver", "--device", "cpu", "--port", submit_port,
                     "--chkp-root", chkp_root, "--ha-replica-id", replica_id])


if __name__ == "__main__":
    sys.exit(main())
