"""List buckets and keys of a store file (reference: internal/dumpKeys).

Usage: python -m semadb_tpu.tools.dumpkeys <store-file> [bucket]
"""

from __future__ import annotations

import sys

from semadb_tpu_torch.store.diskstore import open_store


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit(__doc__)
    store = open_store(argv[0])
    only = argv[1] if len(argv) > 1 else None

    def reader(bm):
        for name in sorted(bm.bucket_names()):
            if only and name != only:
                continue
            b = bm.get(name)
            print(f"[{name}] ({len(b)} keys)")
            for k, v in b.items():
                print(f"  {k!r} -> {len(v)} bytes")

    store.read(reader)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
