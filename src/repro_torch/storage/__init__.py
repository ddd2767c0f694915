"""Tiered compressed storage for patient histories + checkpoint plumbing.

The residency story below device memory: :mod:`~repro_torch.storage.codec`
(delta-of-timestamp + varint block codec, exact roundtrip for any int32
history), :mod:`~repro_torch.storage.blockstore` (disk block files + JSON
index, crc-verified, atomically flushed), :mod:`~repro_torch.storage.tiers`
(the ``ResidencyTier`` protocol with host and disk implementations the
:class:`~repro_torch.stream.store.PatientStore` walks), and
:mod:`~repro_torch.storage.state` (checkpoint state trees).

Numpy and file code only: blocks, segments and indexes are byte-identical
to the reference package's, so a blockstore written by either package
reads back in the other.
"""
from repro_torch.storage.blockstore import CompressedBlockStore  # noqa: F401
from repro_torch.storage.codec import (CodeDictionary, decode_block,  # noqa: F401
                                       decode_key, encode_block, encode_key)
from repro_torch.storage.state import pack_tree, unpack_tree  # noqa: F401
from repro_torch.storage.tiers import DiskTier, HostTier, ResidencyTier  # noqa: F401
