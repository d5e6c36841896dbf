"""Time-series query engine SPI + the builtin 'simpleql' language.

A copy of pinot_tpu/timeseries (ref pinot-timeseries: pinot-timeseries-spi's
TimeBuckets, TimeSeriesBlock, BaseTimeSeriesPlanNode and
TimeSeriesLogicalPlanner; pinot-timeseries-planner; the m3ql pipe language
under pinot-plugins/pinot-timeseries-lang). Languages register in spi's
table and plan into the node tree that engine.execute_plan runs.
"""
from pinot_tpu_torch.timeseries.spi import (BaseTimeSeriesPlanNode,
                                            LeafTimeSeriesPlanNode,
                                            TimeBuckets, TimeSeries,
                                            TimeSeriesBlock,
                                            TimeSeriesAggregationNode,
                                            TimeSeriesTransformNode,
                                            get_language, register_language)
from pinot_tpu_torch.timeseries.engine import execute_plan, query

__all__ = ["TimeBuckets", "TimeSeries", "TimeSeriesBlock",
           "BaseTimeSeriesPlanNode", "LeafTimeSeriesPlanNode",
           "TimeSeriesAggregationNode", "TimeSeriesTransformNode",
           "register_language", "get_language", "execute_plan", "query"]
