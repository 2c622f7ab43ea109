"""Streaming runtime of the port: sample sources and the block engine."""

from .gps_service import GpsReceiver
from .source import (BlockRing, DeviceSceneSource, FileSource, Int24FileSource,
                     SampleSource, SyntheticSource, ThreadedSource)
from .stream import ChannelCtl, PackedFetch, StreamEngine
from .sharded_stream import ShardedStreamEngine

__all__ = ["BlockRing", "ChannelCtl", "DeviceSceneSource", "FileSource",
           "GpsReceiver", "Int24FileSource", "PackedFetch", "SampleSource",
           "ShardedStreamEngine", "StreamEngine", "SyntheticSource",
           "ThreadedSource"]
