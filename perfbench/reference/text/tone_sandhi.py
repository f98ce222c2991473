"""Mandarin tone sandhi over tone-numbered pinyin, POS-aware.

Behavioral reference: reference text/frontend/tone_sandhi.py (the
PaddleSpeech ToneSandhi rules), re-expressed as pure functions over
(word, jieba-POS, [syllable]) triples:

  * neutral tone: reduplication (奶奶), particle suffixes (吧/呢/的/了/着/过),
    们/子 after nouns, locative 上/下/里, directional 来/去, measure-word 个,
    and a vendored ~400-word conventional neutral-tone vocabulary
    (linguistic-constant data, same inventory as ref tone_sandhi.py:24-68)
  * 不: neutral inside X不X (看不懂), bu2 before tone 4
  * 一: numeric sequences keep yi1, 第一 keeps yi1, reduplication 看一看 ->
    neutral, yi2 before tone 4, yi4 otherwise
  * third tone: word-structure-aware 3-3 -> 2-3 using jieba sub-word splits
  * pre-merge pass joining 不/一/reduplications/儿/all-third-tone neighbours
    so the word-level rules see the same units as the reference

The word splitter uses jieba when importable (it is baked into this image)
and falls back to a balanced split otherwise.
"""

from __future__ import annotations

from perfbench.reference.text.pinyin_dict import word_to_pinyin

# Conventional neutral-tone vocabulary: the final syllable of these words is
# read tone-5 in standard Mandarin. Linguistic-constant data (same inventory
# as reference tone_sandhi.py:24-68, which the output contract depends on).
NEUTRAL_TONE_WORDS = set("""
麻烦 麻利 鸳鸯 高粱 骨头 骆驼 马虎 首饰 馒头 馄饨 风筝 难为 队伍 阔气
闺女 门道 锄头 铺盖 铃铛 铁匠 钥匙 里脊 里头 部分 那么 道士 造化 迷糊
连累 这么 这个 运气 过去 软和 转悠 踏实 跳蚤 跟头 趔趄 财主 豆腐 讲究
记性 记号 认识 规矩 见识 裁缝 补丁 衣裳 衣服 衙门 街坊 行李 行当 蛤蟆
蘑菇 薄荷 葫芦 葡萄 萝卜 荸荠 苗条 苗头 苍蝇 芝麻 舒服 舒坦 舌头 自在
膏药 脾气 脑袋 脊梁 能耐 胳膊 胭脂 胡萝 胡琴 胡同 聪明 耽误 耽搁 耷拉
耳朵 老爷 老实 老婆 老头 老太 翻腾 罗嗦 罐头 编辑 结实 红火 累赘 糨糊
糊涂 精神 粮食 簸箕 篱笆 算计 算盘 答应 笤帚 笑语 笑话 窟窿 窝囊 窗户
稳当 稀罕 称呼 秧歌 秀气 秀才 福气 祖宗 砚台 码头 石榴 石头 石匠 知识
眼睛 眯缝 眨巴 眉毛 相声 盘算 白净 痢疾 痛快 疟疾 疙瘩 疏忽 畜生 生意
甘蔗 琵琶 琢磨 琉璃 玻璃 玫瑰 玄乎 狐狸 状元 特务 牲口 牙碜 牌楼 爽快
爱人 热闹 烧饼 烟筒 烂糊 点心 炊帚 灯笼 火候 漂亮 滑溜 溜达 温和 清楚
消息 浪头 活泼 比方 正经 欺负 模糊 槟榔 棺材 棒槌 棉花 核桃 栅栏 柴火
架势 枕头 枇杷 机灵 本事 木头 木匠 朋友 月饼 月亮 暖和 明白 时候 新鲜
故事 收拾 收成 提防 挖苦 挑剔 指甲 指头 拾掇 拳头 拨弄 招牌 招呼 抬举
护士 折腾 扫帚 打量 打算 打点 打扮 打听 打发 扎实 扁担 戒指 懒得 意识
意思 情形 悟性 怪物 思量 怎么 念头 念叨 快活 忙活 志气 心思 得罪 张罗
弟兄 开通 应酬 庄稼 干事 帮手 帐篷 希罕 师父 师傅 巴结 巴掌 差事 工夫
岁数 屁股 尾巴 少爷 小气 小伙 将就 对头 对付 寡妇 家伙 客气 实在 官司
学问 学生 字号 嫁妆 媳妇 媒人 婆家 娘家 委屈 姑娘 姐夫 妯娌 妥当 妖精
奴才 女婿 头发 太阳 大爷 大方 大意 大夫 多少 多么 外甥 壮实 地道 地方
在乎 困难 嘴巴 嘱咐 嘟囔 嘀咕 喜欢 喇嘛 喇叭 商量 唾沫 哑巴 哈欠 哆嗦
咳嗽 和尚 告诉 告示 含糊 吓唬 后头 名字 名堂 合同 吆喝 叫唤 口袋 厚道
厉害 千斤 包袱 包涵 匀称 勤快 动静 动弹 功夫 力气 前头 刺猬 刺激 别扭
利落 利索 利害 分析 出息 凑合 凉快 冷战 冤枉 冒失 养活 关系 先生 兄弟
便宜 使唤 佩服 作坊 体面 位置 似的 伙计 休息 什么 人家 亲戚 亲家 交情
云彩 事情 买卖 主意 丫头 丧气 两口 东西 东家 世故 不由 不在 下水 下巴
上头 上司 丈夫 丈人 一辈 那个 菩萨 父亲 母亲 咕噜 邋遢 费用 冤家 甜头
介绍 荒唐 大人 泥鳅 幸福 熟悉 计划 扑腾 蜡烛 姥爷 照顾 喉咙 吉他 弄堂
蚂蚱 凤凰 拖沓 寒碜 糟蹋 倒腾 报复 逻辑 盘缠 喽啰 牢骚 咖喱 扫把 惦记
""".split())

# words whose trailing 子/reduplication must NOT neutralize
NOT_NEUTRAL_TONE_WORDS = set("男子 女子 分子 原子 量子 莲子 石子 瓜子 电子 人人 虎虎".split())

_PUNC = "：，；。？！“”‘’':,;.?!"
_SENTENCE_FINAL = "吧呢哈啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶"


def _tone(s: str) -> str:
    return s[-1] if s and s[-1] in "12345" else ""


def _set_tone(s: str, tone: str) -> str:
    return (s[:-1] if _tone(s) else s) + tone


def _all_tone_three(sylls: list[str]) -> bool:
    return bool(sylls) and all(_tone(s) == "3" for s in sylls)


def split_word(word: str) -> list[str]:
    """Two-way sub-word split (reference _split_word, jieba-backed)."""
    try:
        import jieba

        pieces = sorted(jieba.cut_for_search(word), key=len)
    except Exception:  # pragma: no cover - jieba is in the image
        pieces = [word[: max(1, len(word) // 2)]]
    first = pieces[0]
    if word.find(first) == 0:
        return [first, word[len(first):]]
    return [word[: -len(first)], first]


def neutral_tone(word: str, sylls: list[str], pos: str = "n") -> list[str]:
    """Neutral-tone rules (reference _neural_sandhi)."""
    out = list(sylls)
    # reduplication of n./v./a. words: 奶奶, 试试
    for j in range(1, len(word)):
        if (
            word[j] == word[j - 1]
            and (pos[:1] in ("n", "v", "a"))
            and word not in NOT_NEUTRAL_TONE_WORDS
            and j < len(out)
        ):
            out[j] = _set_tone(out[j], "5")
    ge_idx = word.find("个")
    if word and word[-1] in _SENTENCE_FINAL:
        out[-1] = _set_tone(out[-1], "5")
    elif word and word[-1] in "的地得":
        out[-1] = _set_tone(out[-1], "5")
    elif len(word) == 1 and word in "了着过" and pos in ("ul", "uz", "ug"):
        out[-1] = _set_tone(out[-1], "5")
    elif (
        len(word) > 1
        and word[-1] in "们子"
        and pos in ("r", "n")
        and word not in NOT_NEUTRAL_TONE_WORDS
    ):
        out[-1] = _set_tone(out[-1], "5")
    elif len(word) > 1 and word[-1] in "上下里" and pos in ("s", "l", "f"):
        out[-1] = _set_tone(out[-1], "5")
    elif len(word) > 1 and word[-1] in "来去" and word[-2] in "上下进出回过起开":
        out[-1] = _set_tone(out[-1], "5")
    elif (
        ge_idx >= 1
        and (word[ge_idx - 1].isnumeric() or word[ge_idx - 1] in "几有两半多各整每做是")
    ) or word == "个":
        if ge_idx < len(out):
            out[ge_idx] = _set_tone(out[ge_idx], "5")
    elif word in NEUTRAL_TONE_WORDS or word[-2:] in NEUTRAL_TONE_WORDS:
        out[-1] = _set_tone(out[-1], "5")

    # sub-word conventional neutral tones (所有人 -> 所有 has none, but
    # e.g. 好朋友 -> 朋友 neutralizes its last syllable)
    if len(word) >= 3:
        parts = split_word(word)
        chunks = [out[: len(parts[0])], out[len(parts[0]):]]
        for i, part in enumerate(parts):
            if (part in NEUTRAL_TONE_WORDS or part[-2:] in NEUTRAL_TONE_WORDS) and chunks[i]:
                chunks[i][-1] = _set_tone(chunks[i][-1], "5")
        out = chunks[0] + chunks[1]
    return out


def bu_sandhi(word: str, sylls: list[str]) -> list[str]:
    """不 rules (reference _bu_sandhi)."""
    out = list(sylls)
    if len(word) == 3 and word[1] == "不":
        out[1] = _set_tone(out[1], "5")
        return out
    for i, ch in enumerate(word):
        if ch == "不" and i + 1 < len(out) and _tone(out[i + 1]) == "4":
            out[i] = _set_tone(out[i], "2")
    return out


def yi_sandhi(word: str, sylls: list[str]) -> list[str]:
    """一 rules (reference _yi_sandhi)."""
    out = list(sylls)
    if "一" in word and all(c.isnumeric() for c in word if c != "一"):
        return out
    if len(word) == 3 and word[1] == "一" and word[0] == word[-1]:
        out[1] = _set_tone(out[1], "5")
        return out
    if word.startswith("第一"):
        if len(out) > 1:
            out[1] = _set_tone(out[1], "1")
        return out
    for i, ch in enumerate(word):
        if ch == "一" and i + 1 < len(word) and i + 1 < len(out):
            if _tone(out[i + 1]) == "4":
                out[i] = _set_tone(out[i], "2")
            elif word[i + 1] not in _PUNC:
                out[i] = _set_tone(out[i], "4")
    return out


def third_tone_sandhi(word: str, sylls: list[str]) -> list[str]:
    """Word-structure-aware 3-3 -> 2-3 (reference _three_sandhi)."""
    out = list(sylls)
    n = len(word)
    if n == 2 and _all_tone_three(out):
        out[0] = _set_tone(out[0], "2")
    elif n == 3 and len(out) == 3:
        parts = split_word(word)
        if _all_tone_three(out):
            if len(parts[0]) == 2:  # disyllabic + monosyllabic: 蒙古/包
                out[0] = _set_tone(out[0], "2")
                out[1] = _set_tone(out[1], "2")
            elif len(parts[0]) == 1:  # monosyllabic + disyllabic: 纸/老虎
                out[1] = _set_tone(out[1], "2")
        else:
            chunks = [out[: len(parts[0])], out[len(parts[0]):]]
            for i, sub in enumerate(chunks):
                if _all_tone_three(sub) and len(sub) == 2:
                    chunks[i][0] = _set_tone(chunks[i][0], "2")
                elif (
                    i == 1
                    and not _all_tone_three(sub)
                    and sub
                    and _tone(sub[0]) == "3"
                    and chunks[0]
                    and _tone(chunks[0][-1]) == "3"
                ):
                    chunks[0][-1] = _set_tone(chunks[0][-1], "2")
            out = chunks[0] + chunks[1]
    elif n == 4 and len(out) == 4:  # idioms: split 2+2
        res: list[str] = []
        for sub in (out[:2], out[2:]):
            if _all_tone_three(sub):
                sub[0] = _set_tone(sub[0], "2")
            res += sub
        out = res
    return out


def modified_tone(word: str, pos: str, sylls: list[str]) -> list[str]:
    """Full per-word pipeline (reference modified_tone ordering)."""
    sylls = bu_sandhi(word, sylls)
    sylls = yi_sandhi(word, sylls)
    sylls = neutral_tone(word, sylls, pos)
    sylls = third_tone_sandhi(word, sylls)
    return sylls


# ---------------------------------------------------------------------------
# Segmentation pre-merge (reference pre_merge_for_modify): joins units so the
# word-level rules above see 不X, X一X, reduplications, trailing 儿, and short
# all-third-tone neighbours as single words.
# ---------------------------------------------------------------------------


def _merge_bu(seg: list[tuple[str, str]]) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    last = ""
    for word, pos in seg:
        if last == "不":
            word = last + word
        if word != "不":
            out.append((word, pos))
        last = word
    if last == "不":
        out.append((last, "d"))
    return out


def _merge_yi(seg: list[tuple[str, str]]) -> list[tuple[str, str]]:
    out: list[list[str]] = []
    # V 一 V -> V一V
    for i, (word, pos) in enumerate(seg):
        if (
            i >= 1
            and word == "一"
            and i + 1 < len(seg)
            and seg[i - 1][0] == seg[i + 1][0]
            and seg[i - 1][1] == "v"
            and out
        ):
            out[-1][0] = out[-1][0] + "一" + out[-1][0]
        elif i >= 2 and seg[i - 1][0] == "一" and seg[i - 2][0] == word and pos == "v":
            continue
        else:
            out.append([word, pos])
    seg2 = out
    out = []
    # lone 一 glues onto the following word
    for word, pos in seg2:
        if out and out[-1][0] == "一":
            out[-1][0] = out[-1][0] + word
        else:
            out.append([word, pos])
    return [(w, p) for w, p in out]


def _merge_reduplication(seg: list[tuple[str, str]]) -> list[tuple[str, str]]:
    out: list[list[str]] = []
    for word, pos in seg:
        if out and word == out[-1][0]:
            out[-1][0] = out[-1][0] + word
        else:
            out.append([word, pos])
    return [(w, p) for w, p in out]


def _is_reduplication(word: str) -> bool:
    return len(word) == 2 and word[0] == word[1]


def _merge_three_tones(
    seg: list[tuple[str, str]], boundary_only: bool
) -> list[tuple[str, str]]:
    """Join neighbours when 3-3 crosses their boundary: full-word all-third
    (boundary_only=False) or just last/first syllable (True)."""
    # lexical-neutral-aware readings, mirroring the reference's
    # lazy_pinyin(..., neutral_tone_with_five=True): 箱子 reads xiang1 zi5,
    # so zi does NOT count as a third tone at the boundary and 箱子+很
    # stays unmerged (keeping 子 word-final for the neutral rule)
    def _neutral_aware(w: str, p: str) -> list[str]:
        s = word_to_pinyin(w)
        if s and len(s) == len(w):
            return neutral_tone(w, s, p)
        return s

    sylls = [_neutral_aware(w, p) for w, p in seg]
    out: list[list[str]] = []
    merged_last = [False] * len(seg)
    for i, (word, pos) in enumerate(seg):
        if i >= 1 and not merged_last[i - 1]:
            prev = sylls[i - 1]
            cur = sylls[i]
            if boundary_only:
                hit = bool(prev) and bool(cur) and _tone(prev[-1]) == "3" and _tone(cur[0]) == "3"
            else:
                hit = _all_tone_three(prev) and _all_tone_three(cur)
            if hit and not _is_reduplication(seg[i - 1][0]) and len(seg[i - 1][0]) + len(word) <= 3:
                out[-1][0] = out[-1][0] + word
                merged_last[i] = True
                continue
        out.append([word, pos])
    return [(w, p) for w, p in out]


def _merge_er(seg: list[tuple[str, str]]) -> list[tuple[str, str]]:
    out: list[list[str]] = []
    for word, pos in seg:
        if word == "儿" and out and out[-1][0] != "#":
            out[-1][0] = out[-1][0] + word
        else:
            out.append([word, pos])
    return [(w, p) for w, p in out]


def pre_merge_for_modify(seg: list[tuple[str, str]]) -> list[tuple[str, str]]:
    seg = _merge_bu(seg)
    seg = _merge_yi(seg)
    seg = _merge_reduplication(seg)
    seg = _merge_three_tones(seg, boundary_only=False)
    seg = _merge_three_tones(seg, boundary_only=True)
    seg = _merge_er(seg)
    return seg


def cross_word_third_tone(words_sylls: list[list[str]]) -> list[list[str]]:
    """Final 3-3 pass across remaining word boundaries (connected speech)."""
    out = [list(s) for s in words_sylls]
    for i in range(len(out) - 1):
        if not out[i] or not out[i + 1]:
            continue
        if _tone(out[i][-1]) == "3" and _tone(out[i + 1][0]) == "3":
            out[i][-1] = _set_tone(out[i][-1], "2")
    return out
