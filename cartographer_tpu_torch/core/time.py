"""Microsecond-resolution time for sensor data ordering.

Equivalent of the reference `cartographer/common/time.{h,cc}`: the reference
uses 100ns "universal" ticks since year 0001 (UTS); here `Time` is an int64
count of **microseconds** since the Unix epoch, which is what host queues sort
on and what device code carries as int64 scalars. Conversions to/from the
reference's universal ticks are provided for pbstream compatibility.
"""

from __future__ import annotations

# Offset between 0001-01-01 and 1970-01-01 in seconds (astronomical, matching
# the reference's kUtsEpochOffsetFromUnixEpochInSeconds, common/time.h).
_UTS_EPOCH_OFFSET_SECONDS = 719162 * 24 * 60 * 60

Time = int  # microseconds since Unix epoch
Duration = int  # microseconds


def from_seconds(seconds: float) -> Duration:
    """Seconds -> Duration (μs), rounding to nearest like common::FromSeconds."""
    return int(round(seconds * 1e6))


def to_seconds(duration: Duration) -> float:
    return duration * 1e-6


def from_universal(uts_ticks: int) -> Time:
    """Reference universal 100ns ticks since 0001 -> μs since Unix epoch."""
    return uts_ticks // 10 - _UTS_EPOCH_OFFSET_SECONDS * 1_000_000


def to_universal(time: Time) -> int:
    """μs since Unix epoch -> reference universal 100ns ticks since 0001."""
    return (time + _UTS_EPOCH_OFFSET_SECONDS * 1_000_000) * 10
