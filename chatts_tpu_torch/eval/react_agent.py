"""ReAct agent baseline: LLM + 9 time-series tools.

The port's copy of ``chatts_tpu/eval/react_agent.py``.

Behavioral re-implementation of the reference agent
(reference: evaluation/react_agent.py:308-632): Thought / Action / Action
Input / Observation loop with a ``\\nObservation`` stop sequence, a 20-step
cap, and tool dispatch over datapoint/datarange value queries, STL
decomposition, AR anomaly detection (single + multi), ROCKET window
classification (single + multi), pearson similarity, STL-trend correlation,
and anomaly-position fluctuation correlation — all running on the native
implementations in :mod:`chatts_tpu_torch.eval.ts_tools`.
"""
from __future__ import annotations

import json
from typing import Callable, List, Optional, Sequence

import numpy as np

from chatts_tpu_torch.eval import ts_tools
from chatts_tpu_torch.eval.scorers import match_metric_name
from chatts_tpu_torch.utils.json_utils import parse_llm_json

MAX_STEPS = 20  # reference: react_agent.py:597 region


def col_idx(name: str, cols: Sequence[str]) -> int:
    for i, col in enumerate(cols):
        if match_metric_name(col, name):
            return i
    raise RuntimeError(f"Metric: {name} not found")


def _classify_window(ts: np.ndarray, position: int, clf) -> str:
    start = min(max(0, position - 32), max(0, len(ts) - 64))
    window = np.asarray(ts)[start : start + 64]
    if len(window) != 64:
        return "Invalid window position"
    return str(clf.predict(window[np.newaxis, :])[0])


def call_plugin(
    plugin_name: str,
    plugin_args: str,
    timeseries: List,
    cols: List[str],
    rocket_path: Optional[str] = None,
) -> str:
    """Dispatch a tool call (reference: react_agent.py:308-353)."""
    try:
        args = parse_llm_json(plugin_args) or {}
        if plugin_name == "datapoint_value":
            idx = col_idx(args["name"], cols)
            pos = int(args["position"])
            return (
                f"The value of datapoint {pos} in {args['name']} is "
                f"{float(timeseries[idx][pos]):.2f}"
            )
        if plugin_name == "datarange_value":
            idx = col_idx(args["name"], cols)
            a, b = int(args["position_start"]), int(args["position_end"])
            values = [round(float(timeseries[idx][p]), 3) for p in range(a, b)]
            return (
                f"The value between datapoint {a} and datapoint {b} in "
                f"{args['name']} is {values}"
            )
        if plugin_name == "stl_decomposition":
            idx = col_idx(args["name"], cols)
            return ts_tools.stl_tool(np.asarray(timeseries[idx]))
        if plugin_name == "anomaly_detection":
            idx = col_idx(args["name"], cols)
            return ts_tools.anomaly_detection_tool(np.asarray(timeseries[idx]))
        if plugin_name == "anomaly_detection_multi":
            return ts_tools.anomaly_detection_multi_tool(timeseries, cols)
        if plugin_name == "classification":
            if rocket_path is None:
                return "Classification model not available."
            clf = ts_tools.RocketClassifier.load(rocket_path)
            idx = col_idx(args["name"], cols)
            label = _classify_window(
                np.asarray(timeseries[idx]), int(args["position"]), clf
            )
            return "The classification result is " + label
        if plugin_name == "classification_multi":
            if rocket_path is None:
                return "Classification model not available."
            clf = ts_tools.RocketClassifier.load(rocket_path)
            pos = int(args["position"])
            lines = [
                f"- {col}: {_classify_window(np.asarray(ts), pos, clf)}"
                for col, ts in zip(cols, timeseries)
            ]
            return "Classification results:\n" + "\n".join(lines)
        if plugin_name == "similarity":
            return ts_tools.correlation_tool(
                timeseries, col_idx(args["name"], cols), cols
            )
        if plugin_name == "trend_correlation":
            return ts_tools.trend_correlation_tool(
                timeseries, col_idx(args["name"], cols), cols
            )
        if plugin_name == "fluctuation_correlation":
            return ts_tools.fluctuation_correlation_tool(
                timeseries, col_idx(args["name"], cols), cols
            )
        return (
            f"plugin: {plugin_name} not found! You have to strictly format "
            "your Action (just put tool name here) and Action Input (just "
            "put the json format input here) to use the tools. If you want "
            "to output the final answer, strictly format it to: Final "
            "Answer: the final answer to the original input question."
        )
    except Exception as err:
        return f"Error when calling {plugin_name}: {err}"


TOOL_SPECS = [
    ("datapoint_value", "Datapoint Value",
     "Output the value of a time series datapoint according to the input position.",
     [("position", "int", "The position of the point to query (0 to seq_len - 1)."),
      ("name", "string", "The name of the time series to query.")]),
    ("datarange_value", "Datarange Value",
     "Output the values (in list format) of the datapoints between the range [position_start, position_end).",
     [("position_start", "int", "The start position of the data range"),
      ("position_end", "int", "The end position of the data range"),
      ("name", "string", "The name of the time series to query.")]),
    ("stl_decomposition", "STL Decomposition",
     "Output the trend values, seasonal (period and max/min values), and residual (std) values after stl decomposition.",
     [("name", "string", "The name of the time series to do the stl decomposition.")]),
    ("anomaly_detection", "Anomaly Detection",
     "Detect anomalous points in one time series with an autoregression detector and output their start positions.",
     [("name", "string", "The name of the time series to analyze.")]),
    ("anomaly_detection_multi", "Anomaly Detection (All Series)",
     "Detect anomalous points in every provided time series at once.", []),
    ("classification", "Local Change Classification",
     "Classify the local-change type of a 64-point window around the given position.",
     [("name", "string", "The name of the time series."),
      ("position", "int", "The center position of the window.")]),
    ("classification_multi", "Local Change Classification (All Series)",
     "Classify 64-point windows around the given position for every series.",
     [("position", "int", "The center position of the window.")]),
    ("similarity", "Pearson Similarity",
     "Compute the pearson correlation between one series and every other series.",
     [("name", "string", "The name of the source time series.")]),
    ("trend_correlation", "Trend Correlation",
     "Compute STL-trend correlations between one series and every other series, flagging correlations above 0.7.",
     [("name", "string", "The name of the source time series.")]),
    ("fluctuation_correlation", "Fluctuation Correlation",
     "Match anomaly positions between one series and every other series with 5% tolerance.",
     [("name", "string", "The name of the source time series.")]),
]

TOOL_DESC = (
    "{name_for_model}: Call this tool to interact with the {name_for_human} "
    "API. The {name_for_human} API is useful for: {description_for_model} "
    "Parameters: {parameters}. Format the arguments as a JSON object."
)

REACT_PROMPT = """Answer the following questions as best you can. You have access to the following tools:

{tool_descs}

Use the following format:

Question: the input question you must answer
Thought: you should always think about what to do
Action: the action to take, should be one of [{tool_names}]
Action Input: the input to the action
Observation: the result of the action
... (this Thought/Action/Action Input/Observation can be repeated zero or more times, as needed but no more than 10 times)
Thought: I now know the final answer
Final Answer: the final answer to the original input question

Begin!

Question: {question}"""


def build_react_prompt(question: str) -> str:
    tool_descs = []
    for name, human, desc, params in TOOL_SPECS:
        parameters = [
            {"name": p, "description": d, "required": True,
             "schema": {"type": t}}
            for p, t, d in params
        ]
        tool_descs.append(
            TOOL_DESC.format(
                name_for_model=name, name_for_human=human,
                description_for_model=desc,
                parameters=json.dumps(parameters),
            )
        )
    return REACT_PROMPT.format(
        tool_descs="\n\n".join(tool_descs),
        tool_names=",".join(s[0] for s in TOOL_SPECS),
        question=question,
    )


def parse_latest_plugin_call(text: str):
    """Extract the last Action / Action Input pair, normalizing a missing
    Observation marker (reference: react_agent.py:28-46)."""
    i = text.rfind("\nAction:")
    j = text.rfind("\nAction Input:")
    k = text.rfind("\nObservation:")
    if 0 <= i < j:
        if k < j:
            text = text.rstrip() + "\nObservation:"
            k = text.rfind("\nObservation:")
        plugin_name = text[i + len("\nAction:") : j].strip()
        plugin_args = text[j + len("\nAction Input:") : k].strip()
        return plugin_name, plugin_args, text
    return "", "", text


def answer_question_react(
    question: str,
    timeseries: List,
    cols: List[str],
    llm: Callable[[str], str],
    rocket_path: Optional[str] = None,
    max_steps: int = MAX_STEPS,
) -> str:
    """Run the ReAct loop until Final Answer or the step cap.

    ``llm`` is any prompt -> completion callable that honors the
    ``\\nObservation`` convention (completions should stop before inventing
    observations; trailing text after an Action Input is tolerated).
    """
    prompt = build_react_prompt(question)
    for _ in range(max_steps):
        completion = llm(prompt)
        # Emulate the stop sequence: truncate anything the model invented
        # after an Observation marker.
        stop_at = completion.find("\nObservation")
        if stop_at != -1:
            completion = completion[:stop_at]
        prompt += completion
        if "Final Answer:" in completion:
            return completion.split("Final Answer:", 1)[1].strip()
        plugin_name, plugin_args, prompt = parse_latest_plugin_call(prompt)
        if not plugin_name:
            # No tool call and no final answer: treat remainder as answer.
            return completion.strip()
        result = call_plugin(plugin_name, plugin_args, timeseries, cols, rocket_path)
        prompt += "\nObservation:" + json.dumps(result, ensure_ascii=False)
        prompt += "\nThought:"
    return "Max steps reached without a final answer."
