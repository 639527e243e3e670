"""Host data layer: the manifest and event log types and their CSV writers."""
