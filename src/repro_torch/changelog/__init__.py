"""changelog: the one ordered op stream + its subscribers (CDC for STAR),
port of ``repro.changelog``.

``ChangeLog`` owns the epoch/slab-structured record + index op stream the
engine publishes; every consumer — replica replay, WAL durability,
snapshot-catalog stamping, fence byte attribution, and the HTAP
materialized views — is a ``Subscriber``.
"""
from repro_torch.changelog.log import Attribution, ChangeLog
from repro_torch.changelog.views import MaterializedViews, VIEW_COLS
from repro_torch.changelog.analytics import AnalyticsLane

__all__ = ["Attribution", "ChangeLog", "MaterializedViews", "VIEW_COLS",
           "AnalyticsLane"]
