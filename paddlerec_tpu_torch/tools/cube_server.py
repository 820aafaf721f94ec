"""Serve cube KV shards over TCP (the cube fleet daemon): counterpart of
``paddlerec_tpu/tools/cube_server.py``.

Export tables with ``tools/export_cube.py`` (or let the online loop publish
deltas), then:

    python -m paddlerec_tpu_torch.tools.cube_server --dir cube_out/table --port 9527

Several nodes: run one server per shard file and give clients the ordered
address list (``native/cube.py`` ``RemoteCubeClient``).  A host tool: no
device.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="cube KV server")
    parser.add_argument("--dir", help="directory of cube_shard_*.bin")
    parser.add_argument("--shards", nargs="*", default=None,
                        help="explicit shard files (overrides --dir)")
    parser.add_argument("--port", type=int, default=9527)
    args = parser.parse_args(argv)

    shards = args.shards
    if not shards:
        if not args.dir:
            parser.error("need --dir or --shards")
        shards = sorted(glob.glob(os.path.join(args.dir, "cube_shard_*.bin")))
    if not shards:
        parser.error("no cube shards found")

    from paddlerec_tpu_torch.native.cube import build_cube_server

    binary = build_cube_server()
    # exec: the daemon replaces this process (signals and supervisors behave
    # as expected)
    os.execv(binary, [binary, str(args.port), *shards])


if __name__ == "__main__":
    sys.exit(main())
