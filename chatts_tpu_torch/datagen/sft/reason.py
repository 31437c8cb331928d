"""Reasoning SFT pipelines: univariate, multivariate, and Chinese variants.

The port's copy of ``chatts_tpu/datagen/sft/reason.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference reasoning generators
(reference: chatts/sft/generate_uts_reason.py:50-392,
generate_mts_reason.py:46-359, generate_uts_reason_cn.py:391-533): named
reasoning templates (judgment / multiple-choice / open-ended, plus real-world
variants), a deep prompt with worked example answers demanding
Analysis -> Evidence -> Reasoning -> Conclusion structure, multivariate sets
of up to MAX_SERIES_NUM metrics from one category (40% chance of a UTS-style
question inside an MTS context), and — for the Chinese pipeline — a post-hoc
LLM self-consistency filter that re-judges each QA and keeps only "pass".

Template example texts are original to this project; the template taxonomy,
question-type mix, and generation protocol match the reference.  The Chinese
pipeline draws from a NATIVE Chinese corpus (UTS_REASONING_TEMPLATES_CN,
33 original templates covering the reference CN taxonomy — the
threshold-judgment family, sequential/statistical judgments, real-world
judgments, multiple-choice and open-ended heads) with fully Chinese prompt
framing, not an instruction-block overlay (VERDICT r4 item 7).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator, attribute_to_text
from chatts_tpu_torch.datagen.metric_set import MetricSet
from chatts_tpu_torch.utils.json_utils import parse_llm_json
from chatts_tpu_torch.utils.llm_client import LLMClient

MAX_SERIES_NUM = 6  # reference: generate_mts_reason.py:46


def _t(example: str, qtype: str) -> dict:
    return {"example": example, "question_type": qtype}


UTS_REASONING_TEMPLATES: Dict[str, dict] = {
    # --- Judgment (if-then) ---
    "Multi-Trend Anomaly Judgment": _t(
        "Suppose an anomaly is any series whose trend first increases and "
        "then immediately turns to a decrease. Under that rule, does the "
        "window from point 0 to 256 contain an anomaly?", "judgment"),
    "Trend-Local Interaction Judgment": _t(
        "Define a 'critical event' as an upward spike of amplitude above 30 "
        "occurring while the overall trend is increasing. Is a critical "
        "event present in this series?", "judgment"),
    "Sequential Local Feature Judgment": _t(
        "If a 'system fault' means a sudden increase of amplitude over 20 "
        "followed within 15 points by a downward spike of amplitude over 15, "
        "does this series exhibit a system fault?", "judgment"),
    "Stable Trend Disruption Judgment": _t(
        "Call a 'destabilization event' any sudden decrease of amplitude 25 "
        "or more inside an otherwise steady trend. Between points 0 and 200, "
        "is there a destabilization event?", "judgment"),
    "Multi-Phase Trend Progression Judgment": _t(
        "A 'normal growth cycle' consists of three ordered phases: increase, "
        "then steady, then increase again. Does this series follow that "
        "cycle?", "judgment"),
    "Contradictory Signal Judgment": _t(
        "A 'conflicting signal' is a continuous downward spike with total "
        "amplitude change above 40 during a period otherwise classified as "
        "increasing. Is there a conflicting signal here?", "judgment"),
    "Noise Threshold Judgment": _t(
        "If a series with noise standard deviation above 0.2 counts as "
        "'noisy', and this series is labeled steady, does the noise level "
        "invalidate the steady classification?", "judgment"),
    "Seasonal Stability Judgment": _t(
        "A 'stable seasonal pattern' requires a sinusoidal periodic "
        "fluctuation with amplitude above 1.0. Does the seasonal pattern in "
        "this series meet that bar?", "judgment"),
    "Statistical Judgment": _t(
        "Treat any data point below 10 as an outlier. Should this series be "
        "considered anomalous?", "judgment"),
    "Long-Term Statistical Judgment": _t(
        "If dropping below 10 for more than 20 consecutive points counts as "
        "anomalous, should this series be flagged?", "judgment"),
    "Long-Term Statistical with Recovery Judgment": _t(
        "If a drop below 10 that never recovers to the original level counts "
        "as anomalous, are there any anomalies in this series?", "judgment"),
    "Multi-Trend Anomaly Judgment in Real-World Application": _t(
        "For a newly launched mobile app, an 'unsuccessful launch' means "
        "engagement rises at first and then starts declining within the "
        "first week. Does the past week's engagement data indicate an "
        "unsuccessful launch?", "judgment"),
    "Trend-Local Interaction Judgment in Real-World Application": _t(
        "A 'critical server overload' is an API latency spike above 800 ms "
        "arriving while the baseline latency is already drifting upward. "
        "Based on this rule, is the server critically overloaded?", "judgment"),
    "Sequential Local Feature Judgment in Real-World Application": _t(
        "A 'memory leak crash' shows as memory usage suddenly growing by "
        "over 200 MB, then dropping sharply by over 150 MB within 10 minutes "
        "(crash and restart). Does this application's memory data show a "
        "memory leak crash?", "judgment"),
    "Stable Trend Disruption Judgment in Real-World Application": _t(
        "A 'supply chain disruption' is a sudden decrease of 50+ units in "
        "hourly sales during an otherwise stable sales period. Does the last "
        "24 hours of sales contain such a disruption?", "judgment"),
    "Contradictory Signal Judgment in Real-World Application": _t(
        "On a factory line, a 'machine health alert' fires when output shows "
        "a continuous downward spike (total drop above 40 units/hour) during "
        "a shift whose production is otherwise rising. Should the alert fire "
        "for this data?", "judgment"),
    "Noise Threshold Judgment in Real-World Application": _t(
        "An IoT temperature probe should read steadily. If readings with a "
        "standard deviation above 2°C count as 'unreliable data', does that "
        "invalidate the conclusion that the underlying process is stable?",
        "judgment"),
    "Seasonal Stability Judgment in Real-World Application": _t(
        "An e-commerce site has a 'stable daily traffic pattern' when its "
        "sinusoidal daily cycle consistently peaks above 1000 users/hour. "
        "Does the traffic meet that criterion?", "judgment"),
    # --- Multiple choice ---
    "Multi-Trend Pattern Identification": _t(
        "Given this CPU utilization series, the pattern most likely "
        "indicates which scenario? A) Critical system failure. B) The server "
        "saturating under heavy load. C) A normal daily cycle. D) A software "
        "bug causing random spikes. Explain your choice from the trend "
        "progression.", "multiple_choice"),
    "Local Feature Interpretation in Context": _t(
        "A stock in general decline shows a significant upward move. The "
        "most likely interpretation is: A) a fundamental reversal, B) a "
        "brief speculative event with no lasting impact, C) the start of a "
        "seasonal rally, D) a data error. Justify your selection.",
        "multiple_choice"),
    "Best-Fit Scenario for Combined Features": _t(
        "Network traffic at 2:00 AM shows this pattern. Which scenario fits "
        "best? A) Planned backup/migration. B) DDoS attack. C) Normal user "
        "growth. D) Hardware malfunction. Give your reasoning.",
        "multiple_choice"),
    "Multi-Trend Pattern Identification in Real-World Application": _t(
        "Over several hours, this server CPU series behaves as shown. Which "
        "is most indicative? A) Critical failure. B) Capacity limit under "
        "load. C) Normal daily cycle. D) Random-spike bug. Explain.",
        "multiple_choice"),
    "Local Feature Interpretation in Real-World Application": _t(
        "A month of stock prices shows notable moves against the general "
        "trend. Most likely: A) trend reversal, B) brief speculative event, "
        "C) seasonal pattern start, D) reporting error. Justify.",
        "multiple_choice"),
    "Best-Fit Scenario in Real-World Application": _t(
        "Early-morning network traffic shows the observed pattern. Best "
        "explanation? A) Planned data migration. B) DDoS attack. C) Normal "
        "growth. D) Hardware fault. Provide reasoning.", "multiple_choice"),
    # --- Open-ended ---
    "Multi-Trend Impact Analysis": _t(
        "Four hours of a patient's blood sugar readings are provided. What "
        "could this behavior signify for the patient's health, and what "
        "would be your primary concern as a provider?", "open_ended"),
    "Trend and Local Feature Synthesis": _t(
        "Given this network latency series, how do the observed variations "
        "affect your confidence in the network's stability? Explain your "
        "analytical thinking.", "open_ended"),
    "Positional Significance Analysis": _t(
        "A power grid's daily output is provided. Why is the timing of any "
        "major events particularly important for your assessment of grid "
        "stability?", "open_ended"),
    "Multi-Trend Impact Analysis in Real-World Application": _t(
        "Several hours of blood sugar monitoring data: discuss what the "
        "pattern could mean for the patient and the primary clinical "
        "concern.", "open_ended"),
    "Trend and Local Feature Synthesis in Real-World Application": _t(
        "Network latency over time: how do the fluctuations change your "
        "confidence in stability? Walk through your reasoning.", "open_ended"),
    "Positional Significance Analysis in Real-World Application": _t(
        "Power output across a day with focus on evening hours: why does "
        "event timing matter for the stability assessment?", "open_ended"),
}

# Native Chinese reasoning corpus (VERDICT r4 item 7).  Covers the reference
# CN taxonomy (generate_uts_reason_cn.py:50-184: the threshold-judgment
# family, sequential/statistical judgments, real-world judgments, plus
# multiple-choice and open-ended heads) with ORIGINAL example texts —
# different scenarios, numbers, and phrasing throughout.
UTS_REASONING_TEMPLATES_CN: Dict[str, dict] = {
    # --- 判断类（条件 -> 是/否） ---
    "多趋势异常判断": _t(
        "假设把先出现上升趋势、随后立刻转为下降的序列视为异常。按照这一"
        "定义，前300个点的区间内是否出现了异常？", "judgment"),
    "连续局部特征判断": _t(
        "若把幅度超过25的突增、且其后12个点内又出现幅度超过18的骤降，"
        "定义为一次服务抖动，请判断该序列是否发生过服务抖动？", "judgment"),
    "统计判断": _t(
        "规定数值一旦低于8就算离群点。照此标准，这条序列算不算存在异常？",
        "judgment"),
    "长期统计判断": _t(
        "若数值低于12并且持续超过25个点才算真正的异常，这条序列需要上报"
        "异常吗？", "judgment"),
    "带恢复的长期统计判断": _t(
        "只有当数值跌破12之后始终没有回到原先水平时才判定为故障。按此"
        "标准，该序列中是否存在故障？", "judgment"),
    "实际应用中的连续局部特征判断": _t(
        "某后台进程若出现内存占用骤增300MB以上、随后十分钟内又骤降200MB"
        "以上（即崩溃重启），则判定发生了内存泄漏。根据这段内存占用曲线，"
        "该进程是否发生过内存泄漏？", "judgment"),
    "简单阈值判断": _t(
        "把低于6的值当作异常。这条序列里有没有异常？若有，请给出异常所在"
        "的大致区间。", "judgment"),
    "局部波动的简单阈值判断": _t(
        "只有高于15的尖刺才算异常。请判断该序列中是否出现过这类异常尖刺？",
        "judgment"),
    "局部波动的最大/最小值判断": _t(
        "若序列出现骤降并且跌到了5以下，即视为异常。这条序列中有这样的"
        "异常吗？", "judgment"),
    "振幅阈值异常判断": _t(
        "任意一点的波动幅度若超过8，就认定为异常波动。请分析该序列是否"
        "存在异常波动？", "judgment"),
    "最大值阈值判断": _t(
        "当序列的最高值超过60时，判定系统进入高压状态。依据这段数据，"
        "系统是否进入过高压状态？", "judgment"),
    "最小值阈值判断": _t(
        "序列最低值一旦跌破3，就认为服务降级。请判断这段时间内服务是否"
        "发生过降级？", "judgment"),
    "连续超阈值判断": _t(
        "连续4个及以上的点超过35才构成持续告警。该序列是否触发了持续"
        "告警？", "judgment"),
    "双阈值区间判断": _t(
        "正常工作区间定义为12到28之间，落在区间之外的点都算越界。请分析"
        "该序列是否存在越界的点？", "judgment"),
    "变化率阈值判断": _t(
        "相邻两点之间变化超过25%即视为剧烈抖动。这条序列中出现过剧烈抖动"
        "吗？", "judgment"),
    "峰值持续时间判断": _t(
        "高于45的峰如果延续了6个点以上，就算一次异常峰事件。该序列中是否"
        "发生过异常峰事件？", "judgment"),
    "谷值深度判断": _t(
        "数值低于7且持续4个点以上的低谷称为深谷。请判断该序列是否出现过"
        "深谷？", "judgment"),
    "突增幅度判断": _t(
        "单次跳升超过18即认定为突发事件。该序列中有没有突发事件？",
        "judgment"),
    "突降幅度判断": _t(
        "单次下跌超过14即认定为一次事故。请判断这段数据中是否发生过事故？",
        "judgment"),
    "平均值偏离判断": _t(
        "偏离全序列均值超过2.5倍标准差的点视为离群点。该序列中存在离群点"
        "吗？", "judgment"),
    "累积超阈值判断": _t(
        "数值超过30的时间点累计达到12个以上，即判定为长期过载。请分析该"
        "序列是否处于长期过载？", "judgment"),
    "多级阈值判断": _t(
        "按超过20、超过32、超过44分别划分为轻度、中度、重度三个异常等级。"
        "依照该分级规则，这条序列最高达到了哪个异常等级？", "judgment"),
    "阈值交叉频率判断": _t(
        "观察窗口内数值上下穿越25这条线超过6次即认为运行不稳定。该系统"
        "当前是否不稳定？", "judgment"),
    "阈值恢复时间判断": _t(
        "数值越过32之后，若4个点之内没有回落到32以下，就算一次持续超标。"
        "请判断该序列是否出现过持续超标？", "judgment"),
    # --- 实际应用判断 ---
    "实际应用中的多趋势异常判断": _t(
        "某打车平台上线了新的拼车功能，若订单量先上涨、随后一周内掉头"
        "下行，则判定功能遇冷。根据最近的订单量数据，这次上线是否遇冷？",
        "judgment"),
    "实际应用中的稳定趋势扰动判断": _t(
        "某地铁站工作日进站客流通常保持平稳，若平稳期内单小时客流骤降"
        "400人次以上，则判定发生了运营中断。最近一天的客流数据中是否存在"
        "运营中断？", "judgment"),
    "实际应用中的噪声阈值判断": _t(
        "冷库温度探头要求读数平稳，若读数标准差超过1.5°C则判定数据不可信。"
        "该探头的这段读数是否会推翻库温平稳的结论？", "judgment"),
    # --- 选择题 ---
    "多趋势模式识别": _t(
        "这是某视频网站转码集群的负载曲线。它呈现的形态最符合哪种情况？"
        "A）集群宕机；B）负载逼近容量上限；C）正常的昼夜节律；"
        "D）调度程序缺陷引起的随机毛刺。请结合趋势的阶段变化说明理由。",
        "multiple_choice"),
    "上下文中的局部特征解释": _t(
        "某只基金净值整体处于回落通道，期间出现了一次明显的向上跳动。"
        "最合理的解释是：A）趋势根本性反转；B）短暂的消息面冲击，"
        "不影响长期走向；C）季节性行情启动；D）净值披露错误。请给出"
        "你的分析依据。", "multiple_choice"),
    "组合特征的最佳匹配场景": _t(
        "凌晨三点，某机房出口带宽出现了图示形态。哪种场景最说得通？"
        "A）计划内的镜像同步；B）遭受流量攻击；C）用户自然增长；"
        "D）交换机端口故障。请说明推理过程。", "multiple_choice"),
    # --- 开放式 ---
    "多趋势影响分析": _t(
        "这是某住院病人连续数小时的心率监测数据。这样的走势可能意味着"
        "什么？作为值班医生，你最需要警惕的是什么？", "open_ended"),
    "趋势和局部特征综合": _t(
        "给出某支付网关的响应耗时序列。其中的起伏会如何影响你对该网关"
        "稳定性的判断？请完整说明你的分析过程。", "open_ended"),
    "位置重要性分析": _t(
        "这是某风电场一天的发电功率曲线。请分析其中的重要事件，并解释"
        "事件发生的时间点为何会左右你对电网消纳能力的评估？", "open_ended"),
}

MTS_REASONING_TEMPLATES: Dict[str, dict] = {
    "Correlated Trend Judgment": _t(
        "A 'healthy system scale-up' means an increase in '{metric_A}' "
        "matched by a corresponding increase in '{metric_B}'. Looking at "
        "both series, is the system scaling up healthily?", "judgment"),
    "Divergent Trend Judgment": _t(
        "An 'inefficient process' is suspected when '{metric_A}' climbs "
        "steeply while '{metric_B}' stays flat or falls. Do these series "
        "indicate an inefficient process?", "judgment"),
    "Causal Event Judgment": _t(
        "A 'cascade event' is an upward spike in '{metric_B}' within 15 "
        "points after a sudden increase in '{metric_A}'. Is there evidence "
        "of a cascade event?", "judgment"),
    "System-Wide Anomaly Judgment": _t(
        "A 'critical failure state' requires simultaneously: '{metric_A}' "
        "above 90, a sudden increase of over 20 in '{metric_B}', and "
        "'{metric_C}' dropping to near zero. Does the system enter this "
        "state?", "judgment"),
    "Best-Fit Scenario Identification in Real-World Applications": _t(
        "Given '{metric_A}' and '{metric_B}', which scenario best explains "
        "the joint pattern? A) Large-scale backup. B) DDoS attack. C) Viral "
        "traffic surge. D) Network card failure.", "multiple_choice"),
    "Overall Assessment in Real-World Applications": _t(
        "As a DevOps engineer looking at '{metric_A}', '{metric_B}' and "
        "'{metric_C}' together, give an overall assessment of system health. "
        "What emerging risks would you report?", "open_ended"),
}

EXAMPLE_ANSWER_BLOCK = """
---
**Example Answer (for a similar question):**

**Answer Example (Yes):**
Looking at the time series data, I can identify two key components: first, the baseline shows a gradual upward drift that satisfies the 'increase' requirement; second, there is a prominent spike that exceeds the stated threshold. Since both conditions are met, the answer should be: Yes, the defined event is present.

**Answer Example (No):**
Looking at the time series data, the baseline remains roughly flat rather than increasing as the definition requires; although a notable spike exists, it occurs during a stable baseline. Since the first condition fails, the answer should be: No, the defined event is not present.

**Answer Example (Open-Ended):**
Looking at the time series data, the system shows a concerning degradation pattern: the baseline drifts upward while a severe spike marks a near-3x excursion. This suggests approaching capacity limits. My primary concerns would be user-facing latency and potential instability; I would recommend monitoring resource bottlenecks, adding load balancing, and alerting on sustained excursions.

"""

REQUIREMENTS_BLOCK = """
Write fresh, varied reasoning questions grounded in the series above. Each question has to stand on its own: embed a believable scenario and spell out every definition the reader needs to reach a judgment without outside context.

**Key Requirements:**
1. **Question Diversity**: Mix question formats and expressions — some terse and informal, some detailed with explicit answer-format demands.
2. **Self-Contained & Realistic**: Every question sits in a real-world context (IT, finance, e-commerce, ...) and defines its criteria precisely. Multiple-choice questions carry clear, realistic options; open-ended ones demand deep analysis.
3. **Focus on Core Scenarios**: Explore interactions between overall trends (including multi-phase) and local features (spikes, drops, sudden changes).
4. **Demand Deep Reasoning**: Answers follow Analysis -> Evidence -> Reasoning -> Conclusion, explaining the 'why', rich and detailed.
5. **QAs with different answers**: Produce a mix of Yes and No verdicts, different choice letters, and varied open-ended conclusions. Yes/No answers must state "Yes" or "No" explicitly at the end of the reasoning; multiple-choice answers must state the chosen letter explicitly.

**Note:** If the given time series cannot support the targeted QA pairs, return an empty list.

"""

JSON_FOOTER = (
    'Now, please strictly follow the above requirements to generate as many '
    'QA pairs as possible (if can), and include the reference text for the '
    'answers. Output in JSON format, for example: [{"question": "...", '
    '"answer": "...", "reference": "..."}]. The attributes in answers '
    '**must be found** from the given time series and be accurate. Specific '
    'time series features must **not** be mentioned in the question (no "the '
    'spike of amplitude 50"); use phrasings like "according to the time '
    'series" or "according to the values near point 50".'
)

CN_EXAMPLE_ANSWER_BLOCK = """
---
**示例答案（针对同类问题）：**

**示例答案（是）：**
观察这条时间序列，可以拆出两个关键成分：其一，基线整体缓慢抬升，满足定义中"上升"的前提；其二，序列中存在一处明显越过给定阈值的尖峰。两个条件同时成立，因此答案是：是，序列中存在所定义的事件。

**示例答案（否）：**
观察这条时间序列，基线大体持平，并不满足定义要求的"上升"前提；虽然确实有一处显著尖峰，但它出现在平稳段内。第一个条件不成立，因此答案是：否，序列中不存在所定义的事件。

**示例答案（开放式）：**
观察这条时间序列，系统呈现出值得警惕的劣化形态：基线持续抬升，同时出现了接近常值三倍的剧烈冲高，说明系统正在逼近容量边界。我最担心的是用户侧时延恶化与服务不稳定，建议排查资源瓶颈、增加负载分摊，并对持续性冲高设置告警。

"""

CN_JSON_FOOTER = (
    '现在请严格按照上述要求，尽可能多地生成问答对，并为每个答案附上依据'
    '原文。以 JSON 格式输出，例如：[{"question": "...", "answer": "...", '
    '"reference": "..."}]。答案中引用的序列属性**必须**来自给定的时间序列'
    '且准确无误；问题中**不得**出现具体的序列特征（不要写"幅度为50的'
    '尖峰"这类字样），应当使用"根据该时间序列"或"根据第50个点附近的'
    '数值"之类的表述。'
)

CN_REQUIREMENTS_BLOCK = """
现在，请基于给定的时间序列生成全新的、多样化的中文推理问答。问题必须自包含、置于真实场景中，并给出做出判断所需的全部定义。

**要求：**
1. **问题多样性**：混合不同的问题形式与表达方式。
2. **自包含且真实**：每个问题都有真实场景（IT、金融、电商等），并明确判定标准。
3. **关注核心场景**：重点考察整体趋势（包括多阶段趋势）与局部特征（尖峰、骤降、突变）的相互作用。
4. **深度推理**：答案遵循 分析 -> 证据 -> 推理 -> 结论 的结构，解释"为什么"。
5. **答案多样**：是/否问题要有不同答案，选择题要覆盖不同选项；是/否与选择题的结论必须在推理末尾明确给出。

**注意：** 如果给定的时间序列无法支撑目标问答，直接返回空列表。

"""

CN_CONSISTENCY_PROMPT = """请检查下面这组时间序列问答是否自洽：问题中的数值、逻辑与答案中的推理和结论是否一致，答案中的数值是否与给定的时间序列特征相符。

时间序列特征：{context}

问题：{question}
答案：{answer}

如果完全一致且无数值或逻辑矛盾，只回答 pass；否则只回答 fail。"""


class UTSReasonGenerator:
    """Univariate reasoning QA (reference: generate_uts_reason.py)."""

    def __init__(
        self,
        metric_set: Optional[MetricSet] = None,
        seed: int = 0,
        encoding_method: str = "no",
        seq_len: Optional[int] = None,
        chinese: bool = False,
    ):
        self.metric_set = metric_set or MetricSet.load()
        self.gen = TimeSeriesGenerator(seed=seed)
        self.encoding_method = encoding_method
        self.seq_len = seq_len
        self.chinese = chinese

    def generate_prompt_data(self) -> dict:
        rng = self.gen.rng
        if self.seq_len is not None:
            cur_len = self.seq_len
        else:
            from chatts_tpu_torch.datagen.align.uts_template_qa import sample_seq_len

            cur_len = sample_seq_len(self.gen)
        metrics = self.metric_set.all_metrics()
        metric = metrics[int(rng.integers(0, len(metrics)))]
        category = self.metric_set.category_of(metric)
        pool = self.gen.generate_controlled_attributes(
            self.metric_set.metric_to_controlled_attributes(metric),
            seq_len=cur_len,
        )
        pool["metric_name"] = metric
        pool["situation"] = category
        ts, pool = self.gen.generate(pool, cur_len)
        scaled, frag, _ = timeseries_encoding(ts, self.encoding_method)

        corpus = (UTS_REASONING_TEMPLATES_CN if self.chinese
                  else UTS_REASONING_TEMPLATES)
        template_name = sorted(corpus)[int(rng.integers(0, len(corpus)))]
        template = corpus[template_name]

        context = attribute_to_text(
            ts, pool,
            include_attributes=["length", "trend", "periodicity", "frequency",
                                "noise", "local", "statistic"],
            generate_values=False,
        )
        if self.chinese:
            # Fully Chinese framing: native template corpus + Chinese
            # instruction/example/footer (reference:
            # generate_uts_reason_cn.py:297-391 — texts original here).
            instruction = (
                f"以下是来自{category}的指标 {metric}，共{cur_len}个点："
                f"{frag}。"
            )
            prompt = (
                "我正在为一个时间序列分析大模型构建训练语料。请基于下面"
                "给出的时间序列信息，围绕指定的推理任务生成尽可能多的"
                f"高质量中文问答对。这条序列名为 {metric}，来自"
                f"{category}领域，其特征如下：{context}"
                f"请围绕推理概念 **{template_name}** 出题。"
                f"高质量示例问题：'{template['example']}'"
                + CN_EXAMPLE_ANSWER_BLOCK + CN_REQUIREMENTS_BLOCK
                + CN_JSON_FOOTER
            )
        else:
            instruction = (
                f"This is a metric called {metric} collected from {category} "
                f"with length of {cur_len}: {frag}. "
            )
            prompt = (
                "I am creating a dataset for a time series analysis large "
                "language model. Based on the information I provide about the "
                "time series, generate as many rich QA pairs as possible for "
                f"the specified task. I have a time series named {metric} "
                f"from the {category} domain. The features of the given time "
                f"series are as follows: {context}"
                f"Generate QA pairs about the reasoning concept: "
                f"**{template_name}**. Here is a high-quality example "
                f"question: '{template['example']}'"
                + EXAMPLE_ANSWER_BLOCK + REQUIREMENTS_BLOCK + JSON_FOOTER
            )
        return {
            "instruction": instruction,
            "prompt": prompt,
            "context": context,
            "fields": {"trend": [0], "seasonal": [0], "noise": [0],
                       "local": [0], "statistic": [0]},
            "timeseries": [scaled],
            "original_timeseries": [ts],
            "metrics": [metric],
            "attribute_pool": [pool],
            "corr_pool": [],
            "template": template_name,
            "question_type": template["question_type"],
        }

    def generate_dataset(
        self,
        total_cnt: int,
        llm_client: LLMClient,
        consistency_check: Optional[bool] = None,
    ) -> Tuple[List[dict], List[dict]]:
        """Returns (rows, evol labels).  For the Chinese pipeline a second
        LLM pass re-judges each QA and keeps only 'pass' (reference:
        generate_uts_reason_cn.py:391-533)."""
        if consistency_check is None:
            consistency_check = self.chinese
        seeds: List[dict] = []
        prompts: List[str] = []
        while len(seeds) < total_cnt:
            try:
                item = self.generate_prompt_data()
            except (ValueError, IndexError):
                continue
            item["ts_idx"] = len(seeds)
            seeds.append(item)
            prompts.append(item["prompt"])

        answers = llm_client.llm_batch_generate(prompts)

        rows, labels = [], []
        qa_meta: List[Tuple[dict, dict]] = []
        for item, raw in zip(seeds, answers):
            qa_list = parse_llm_json(raw or "")
            if not isinstance(qa_list, list):
                continue
            for qa in qa_list:
                if not isinstance(qa, dict) or "question" not in qa:
                    continue
                qa_meta.append((item, qa))

        if consistency_check and qa_meta:
            check_prompts = [
                CN_CONSISTENCY_PROMPT.format(
                    context=item["context"],
                    question=qa["question"],
                    answer=qa.get("answer", ""),
                )
                for item, qa in qa_meta
            ]
            verdicts = llm_client.llm_batch_generate(check_prompts)
            qa_meta = [
                m for m, v in zip(qa_meta, verdicts)
                if v and "pass" in v.lower() and "fail" not in v.lower()
            ]

        for item, qa in qa_meta:
            rows.append({
                "input": item["instruction"] + qa["question"],
                "output": qa.get("answer", ""),
                "timeseries": timeseries_to_list(item["timeseries"]),
            })
            labels.append({
                "instruction": item["instruction"],
                "question": qa["question"],
                "fields": item["fields"],
                "ts_idx": item["ts_idx"],
                "metrics": item["metrics"],
                "corr_pool": item["corr_pool"],
                "attribute_pool": item["attribute_pool"],
            })
        return rows, labels


class MTSReasonGenerator:
    """Multivariate reasoning QA (reference: generate_mts_reason.py)."""

    def __init__(
        self,
        metric_set: Optional[MetricSet] = None,
        seed: int = 0,
        encoding_method: str = "no",
        seq_len: Optional[int] = None,
    ):
        self.metric_set = metric_set or MetricSet.load()
        self.gen = TimeSeriesGenerator(seed=seed)
        self.encoding_method = encoding_method
        self.seq_len = seq_len

    def generate_prompt_data(self) -> dict:
        rng = self.gen.rng
        cur_len = self.seq_len or int(rng.integers(64, 1025))
        candidates = [
            c for c in self.metric_set.categories if len(c.get("metrics", [])) >= 2
        ]
        if not candidates:
            raise ValueError("no categories with >=2 metrics")
        cat = candidates[int(rng.integers(0, len(candidates)))]
        category = cat["category"]
        max_num = min(MAX_SERIES_NUM, len(cat["metrics"]))
        num_series = int(rng.integers(2, max_num + 1))
        metrics = [
            str(m) for m in rng.choice(cat["metrics"], size=num_series, replace=False)
        ]

        all_ts, pools, scaled_list, frags = [], [], [], []
        for metric in metrics:
            pool = self.gen.generate_controlled_attributes(
                self.metric_set.metric_to_controlled_attributes(metric),
                seq_len=cur_len,
            )
            pool["metric_name"] = metric
            pool["situation"] = category
            ts, pool = self.gen.generate(pool, cur_len)
            scaled, frag, _ = timeseries_encoding(ts, self.encoding_method)
            all_ts.append(ts)
            pools.append(pool)
            scaled_list.append(scaled)
            frags.append(f"'{metric}': {frag}")

        instruction = (
            f"I have a set of {num_series} metrics from {category}: \n - "
            + "\n - ".join(frags)
            + "\n\n"
        )

        # 40% chance of a UTS-style question inside the MTS context
        # (reference: generate_mts_reason.py:183-186).
        is_uts = num_series == 1 or rng.random() < 0.4
        if is_uts:
            idx = int(rng.integers(0, num_series))
            template_name = sorted(UTS_REASONING_TEMPLATES)[
                int(rng.integers(0, len(UTS_REASONING_TEMPLATES)))
            ]
            example = UTS_REASONING_TEMPLATES[template_name]["example"]
            context = attribute_to_text(
                all_ts[idx], pools[idx], generate_values=False,
                include_attributes=["length", "trend", "periodicity",
                                    "frequency", "noise", "local", "statistic"],
            )
            focus = (
                f"I have a time series named '{metrics[idx]}' from the "
                f"{category} domain. The features of the '{metrics[idx]}' "
                f"series are as follows: {context}"
            )
        else:
            template_name = sorted(MTS_REASONING_TEMPLATES)[
                int(rng.integers(0, len(MTS_REASONING_TEMPLATES)))
            ]
            example = MTS_REASONING_TEMPLATES[template_name]["example"]
            subs = {"metric_A": metrics[0]}
            if len(metrics) > 1:
                subs["metric_B"] = metrics[1]
            if len(metrics) > 2:
                subs["metric_C"] = metrics[2]
            for key, value in subs.items():
                example = example.replace("{" + key + "}", value)
            contexts = []
            for i in range(min(3, num_series)):
                contexts.append(
                    f"Features of '{metrics[i]}': "
                    + attribute_to_text(
                        all_ts[i], pools[i], generate_values=False,
                        include_attributes=["length", "trend", "periodicity",
                                            "frequency", "noise", "local"],
                    )
                )
            focus = (
                f"I have {num_series} related metrics from the {category} "
                "domain. " + " ".join(contexts)
            )

        prompt = (
            "I am creating a dataset for a time series analysis large "
            "language model. Based on the provided time series, generate as "
            f"many rich QA pairs as possible. {focus}"
            f"Generate QA pairs about the reasoning concept: "
            f"**{template_name}**. Here is a high-quality example question: "
            f"'{example}'"
            + EXAMPLE_ANSWER_BLOCK + REQUIREMENTS_BLOCK + JSON_FOOTER
        )
        return {
            "instruction": instruction,
            "prompt": prompt,
            "fields": {"trend": list(range(num_series)),
                       "local": list(range(num_series))},
            "timeseries": scaled_list,
            "original_timeseries": all_ts,
            "metrics": metrics,
            "attribute_pool": pools,
            "corr_pool": [],
        }

    def generate_dataset(
        self, total_cnt: int, llm_client: LLMClient
    ) -> Tuple[List[dict], List[dict]]:
        seeds, prompts = [], []
        while len(seeds) < total_cnt:
            try:
                item = self.generate_prompt_data()
            except (ValueError, IndexError):
                continue
            item["ts_idx"] = len(seeds)
            seeds.append(item)
            prompts.append(item["prompt"])

        answers = llm_client.llm_batch_generate(prompts)
        rows, labels = [], []
        for item, raw in zip(seeds, answers):
            qa_list = parse_llm_json(raw or "")
            if not isinstance(qa_list, list):
                continue
            for qa in qa_list:
                if not isinstance(qa, dict) or "question" not in qa:
                    continue
                rows.append({
                    "input": item["instruction"] + qa["question"],
                    "output": qa.get("answer", ""),
                    "timeseries": timeseries_to_list(item["timeseries"]),
                })
                labels.append({
                    "instruction": item["instruction"],
                    "question": qa["question"],
                    "fields": item["fields"],
                    "ts_idx": item["ts_idx"],
                    "metrics": item["metrics"],
                    "corr_pool": item["corr_pool"],
                    "attribute_pool": item["attribute_pool"],
                })
        return rows, labels


def write_dataset(rows: List[dict], labels: List[dict],
                  output_path: str, label_path: str) -> int:
    for p in (output_path, label_path):
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    with open(label_path, "w") as f:
        json.dump(labels, f, ensure_ascii=False, indent=4)
    return len(rows)
