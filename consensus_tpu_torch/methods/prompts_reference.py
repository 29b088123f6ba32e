"""Reference-faithful Habermas Machine prompt strings (``prompt_style:
reference``), the port's own copy of ``consensus_tpu/methods/prompts_reference.py``.

Welfare numbers are sensitive to exact prompt strings, so quality-parity
runs need the reference's own prompts verbatim.  The four builders below
reproduce the prompt TEXT of the original Habermas Machine method
(``src/methods/habermas_machine.py`` of the paper's code):
``_generate_initial_prompt`` (:440-477),
``_hm_generate_opinion_only_ranking_prompt`` (:586-654),
``_generate_critique_prompt`` (:1263-1310) and
``_generate_revised_statement_prompt`` (:1344-1410).  The strings are a
behavioural contract, not code; ``tests/test_torch_habermas.py`` pins them
equal to the JAX package's.

The default ``prompt_style: tpu`` keeps the house prompts of
``methods/habermas.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def initial_prompt(issue: str, opinions: List[str]) -> str:
    prompt = f"""
You are assisting a citizens' jury in forming an initial consensus opinion on an important question. The jury members have provided their individual opinions. Your role is to generate a draft consensus statement that captures the main points of agreement and represents the collective view of the jury. The draft statement must not conflict with any of the individual opinions.

Please think through this task step-by-step:

1. Carefully analyze the individual opinions, noting key themes, points of agreement, and areas of disagreement.
2. Based on the analysis, synthesize a concise and clear consensus statement that represents the shared perspective of the jury members. Address the core issue posed in the question, and ensure the statement *does not conflict* with any of the individual opinions. Refer to specific opinion numbers to demonstrate how the draft reflects the collective view.
3. Keep the statement to less than 50 tokens.

Provide your answer in the following format:
<answer>
[Your step-by-step reasoning and explanation for the statement]
<sep>
[Draft consensus statement]
</answer>

Example:
<answer>
1. Most opinions emphasize the importance of public transportation (Opinions 1, 3, 4) and reducing car dependency (Opinions 2, 4). Some also mention cycling and walking as important additions (Opinions 2, 3).
2. The draft statement prioritizes investment in public transport and encourages cycling and walking, reflecting the shared views expressed in the majority of opinions.
<sep>
We believe that investing in public transport, along with promoting cycling and walking, are crucial steps towards creating a more sustainable and livable city.
</answer>


Below you will find the question and the individual opinions of the jury members.

Question: {issue}

Individual Opinions:
"""

    for i, opinion in enumerate(opinions):
        prompt += f"Opinion Person {i+1}: {opinion}\n"

    return prompt.strip()


def ranking_prompt(question: str, opinion: str, statements: List[str]) -> str:
    prompt = f"""
Task: As an AI assistant, your job is to rank these statements in the order that the participant would most likely agree with them, based on their opinion. Use Arrow notation for the ranking, where ">" means "preferred to". Ties are NOT allowed and items should be in descending order of preference so you can ONLY use ">" and the letters of the statements in the final ranking. Examples of valid final rankings: B > A, D > A > C > B. B > C > A > E > D.

Please think through this task step-by-step:

1. Analyze the participant's opinion, noting key points and sentiments.
2. Compare each statement to the participant's opinion, considering how well it aligns with or supports their view.
3. Consider any nuances or implications in the statements that might appeal to or repel the participant based on their expressed opinion.
4. Rank the statements accordingly using only ">" and the letters of the statements.

Provide your answer in the following format:
<answer>
[Your step-by-step reasoning and explanation for the ranking]
<sep>
[Final ranking using arrow notation]
</answer>

For example for five statements A, B, C, D and E a valid response could be:
<answer>
1. The participant's opinion emphasizes the importance of environmental protection and the need for immediate action to address climate change.

2. - Statement A directly addresses the urgency of climate action and proposes concrete steps, aligning with the participant's opinion.
   - Statements B and D acknowledge the seriousness of climate change but offer less concrete solutions. B focuses on global cooperation, while D emphasizes economic considerations.
   - Statement C downplays the urgency of climate change, contradicting the participant's stance.
   - Statement E completely opposes the participant's view by denying the existence of climate change.

3.  The participant's emphasis on immediate action suggests a preference for proactive solutions and a dislike for approaches that downplay the issue or offer only abstract ideas.

4. Based on this analysis, the ranking is: A > D > B > C > E

<sep>
A > D > B > C > E
</answer>

It is important to follow the template EXACTLY. So ALWAYS start with <answer>, then the explanation, then <sep> then only the final ranking and then </answer>.


Below you will find the question and the participant's opinion. You will also find a list of statements to rank.

Question: {question}

Participant's Opinion: {opinion}

Statements to rank:
"""
    for i, statement in enumerate(statements):
        letter = chr(ord("A") + i)  # A, B, C, D, etc.
        # Basic cleaning similar to the reference code
        try:
            cleaned_statement = (
                statement.strip().strip('"').strip("'").strip("\n").strip()
            )
        except Exception as e:
            print(f"Warning: Could not clean statement {i}: {statement}. Error: {e}")
            cleaned_statement = statement  # Use original if cleaning fails
        prompt += f"{letter}. {cleaned_statement}\n"

    # Ensure the prompt ends correctly before the LLM call
    prompt += "\nProvide your answer:"

    return prompt.strip()


def critique_prompt(issue: str, opinion: str, proposed_statement: str) -> str:
    prompt = f"""
Task: You are acting as a participant in a deliberation process. Your goal is to critique a proposed consensus statement based *only* on your previously stated opinion. Evaluate how well the proposed statement reflects your views, pointing out specific agreements or disagreements.

Please think through this task step-by-step:

1.  Carefully re-read your original opinion to refresh your key points and priorities regarding the issue.
2.  Analyze the proposed consensus statement.
3.  Compare the proposed statement against your opinion. Does it capture your main points? Does it contradict anything you said? Does it omit something crucial from your perspective?
4.  Formulate a concise critique from your perspective. Focus on specific aspects of the proposed statement and how they relate to your opinion. If the statement is acceptable, explain why. If not, explain the specific shortcomings.

Provide your answer in the following format:
<answer>
[Your step-by-step reasoning comparing the statement to your opinion]
<sep>
[Your final critique of the proposed statement from your perspective]
</answer>

Example:
<answer>
1. My opinion emphasized the need for stricter regulations on industrial emissions as the primary way to improve air quality.
2. The proposed statement focuses on promoting public transport and green spaces.
3. While promoting public transport is good, the statement completely ignores my main point about industrial regulations. It feels incomplete and doesn't address the core issue I raised.
4. The critique should highlight this omission.
<sep>
While I agree that improving public transport is beneficial, this statement fails to address the critical issue of industrial emissions, which was the central point of my opinion. Without including measures to regulate industrial pollution, I cannot fully support this statement as a consensus.
</answer>

It is important to follow the template EXACTLY. So ALWAYS start with <answer>, then the explanation, then <sep> then only the final critique and then </answer>.

Below is the original question, your opinion, and the proposed consensus statement.

Question: {issue}

Your Opinion: {opinion}

Proposed Consensus Statement: {proposed_statement}

Provide your critique based *only* on your opinion:
<answer>
"""
    return prompt.strip()


def revision_prompt(
    issue: str,
    agent_opinions: Dict[str, str],
    winning_statement: str,
    agent_critiques: Dict[str, Optional[str]],
) -> str:
    opinions_list = list(agent_opinions.values())
    critiques_list = list(agent_critiques.values())

    prompt = f"""You are assisting a citizens' jury in forming a consensus opinion on an important question. The jury members have provided their individual opinions, a first draft of a consensus statement was created, and critiques of that draft were gathered. Your role is to generate a revised consensus statement that incorporates the feedback and aims to better represent the collective view of the jury. Ensure the revised statement does not conflict with the individual opinions.

Please think through this task step-by-step:

1. Carefully analyze the individual opinions, noting key themes, points of agreement, and areas of disagreement.
2. Review the previous draft consensus statement and identify its strengths and weaknesses.
3. Analyze the critiques of the previous draft, paying attention to specific suggestions and concerns raised by the jury members.
4. Based on the opinions, the previous draft, and the critiques, synthesize a revised consensus statement that addresses the concerns raised and better reflects the collective view of the jury. Ensure the statement is clear, concise, addresses the core issue posed in the question, and *does not conflict* with any of the individual opinions. Refer to specific opinion and critique numbers when making your revisions.
5. Keep the statement to less than 50 tokens.

Provide your answer in the following format:
<answer>
[Your step-by-step reasoning and explanation for the revised statement]
<sep>
[Revised consensus statement]
</answer>

Example:
<answer>
1. Opinions generally agree on the need for more green spaces (Opinions 1, 2, 3), but disagree on the specific location (Opinions 2 and 3 prefer the riverfront) and funding (Opinion 1 suggests a tax levy, Opinion 3 suggests private donations).
2. The previous draft suggested converting the old factory site into a park, but didn't address funding, which was a key concern in Critique 1.
3. Critiques highlighted the lack of funding details (Critique 1) and some preferred a different location (Critique 2 suggested the riverfront, echoing Opinion 2).
4. The revised statement proposes converting the old factory site into a park, funded by a combination of city funds and private donations (addressing Opinion 3 and Critique 1), and includes a plan for community input on park design and amenities. The factory site is chosen as a compromise location, as it avoids the higher costs associated with the riverfront development suggested in Opinion 2 and Critique 2.
<sep>
We propose converting the old factory site into a park, funded by a combination of city funds and private donations. We will actively seek community input on the park's design and amenities to ensure it meets the needs of our residents.
</answer>


Below you will find the question, the individual opinions, the previous draft consensus statement, and the critiques provided by the jury members.


Question: {issue}

Individual Opinions:
"""
    for i, opinion in enumerate(opinions_list):
        prompt += f"Opinion Person {i+1}: {opinion}\n"

    prompt += f"""
Previous Draft Consensus Statement: {winning_statement}

Critiques of the Previous Draft:
"""

    for i, critique in enumerate(critiques_list):
        prompt += f"Critique Person {i+1}: {critique}\n"

    return prompt.strip()
