"""Streaming runtime of the port: sample sources and the block engine."""

from .source import DeviceSceneSource, SampleSource, SyntheticSource
from .stream import ChannelCtl, StreamEngine

__all__ = ["ChannelCtl", "DeviceSceneSource", "SampleSource",
           "StreamEngine", "SyntheticSource"]
