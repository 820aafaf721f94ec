"""Kubernetes pod discovery and rank assignment (``paddlerec_tpu/utils/k8s.py``).

Pod listing by label selector, waiting for a phase, and trainer ranks by
sorted pod IP, as the reference's ``tools/k8s_tools.py`` does.  The
``kubernetes`` client is optional and imported only when the API is first
needed; without it everything runs from environment variables
(``PADDLEREC_POD_IPS``, ``PADDLE_TRAINER_ID`` / ``RANK``), so single-machine
runs need nothing.
"""

from __future__ import annotations

import os
import socket
import time
from typing import List, Optional, Tuple


def _api():
    try:
        from kubernetes import client as k8s_client
        from kubernetes import config as k8s_config
    except ImportError as e:
        raise RuntimeError(
            "kubernetes client not installed; pod discovery unavailable "
            "(set PADDLEREC_POD_IPS for env-driven rank assignment)"
        ) from e
    if os.getenv("KUBERNETES_SERVICE_HOST"):
        k8s_config.load_incluster_config()
    else:
        k8s_config.load_kube_config()
    return k8s_client.CoreV1Api()


def fetch_pods_info(label_selector: str,
                    phase: Optional[str] = None) -> List[Tuple[str, str, str]]:
    """[(phase, pod_ip, name)] for pods matching the selector."""
    v1 = _api()
    resp = v1.list_namespaced_pod(
        namespace=os.getenv("NAMESPACE", "default"),
        label_selector=label_selector,
    )
    out = []
    for item in resp.items:
        p = item.status.phase
        if item.metadata.deletion_timestamp is not None:
            p = "Terminating"
        if phase is not None and p != phase:
            continue
        out.append((p, item.status.pod_ip, item.metadata.name))
    return out


def count_pods_by_phase(label_selector: str, phase: str) -> int:
    return len(fetch_pods_info(label_selector, phase))


def wait_pods_running(label_selector: str, desired: int,
                      poll_s: float = 5.0) -> None:
    while count_pods_by_phase(label_selector, "Running") < int(desired):
        time.sleep(poll_s)


def pod_ips(label_selector: Optional[str] = None) -> List[str]:
    """Sorted pod IPs: from ``PADDLEREC_POD_IPS`` when set, else the running
    pods of the selector."""
    env = os.getenv("PADDLEREC_POD_IPS")
    if env:
        return sorted(ip for ip in env.split(",") if ip)
    return sorted(
        ip for _, ip, _ in fetch_pods_info(label_selector or "", "Running")
        if ip
    )


def my_rank(label_selector: Optional[str] = None) -> int:
    """This pod's trainer rank: ``PADDLE_TRAINER_ID`` or ``RANK`` when set,
    else the index of its IP in the sorted pod list (the reference assigns
    ``PADDLE_TRAINER_ID`` the same way)."""
    env_rank = os.getenv("PADDLE_TRAINER_ID") or os.getenv("RANK")
    if env_rank is not None:
        return int(env_rank)
    ips = pod_ips(label_selector)
    me = os.getenv("POD_IP") or socket.gethostbyname(socket.gethostname())
    return ips.index(me) if me in ips else 0
