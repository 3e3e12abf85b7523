"""Bytes and operations a unit of work must cost, from its shapes, and
the peaks they are held against."""
